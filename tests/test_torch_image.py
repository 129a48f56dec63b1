"""The port's image codec (``lameness_tpu_torch/video/image.py`` over
``csrc/host/image_codec.cpp``) against OpenCV, the yardstick here (the port
imports no cv2), on seeded numpy images:

- JPEGs that cv2 wrote (quality 50, 75, 95; 4:4:4, 4:2:2, 4:4:0, 4:2:0 and
  gray; widths that are not multiples of 16; restart markers; each EXIF
  orientation) decode within 1 of ``cv2.imread`` at every pixel, and bit
  for bit at 4:4:4 and gray;
- PNGs (cv2-written at several compression levels, and hand-made palette,
  1-16-bit gray, gray+alpha, RGBA and Adam7 files with every filter type)
  decode bit for bit;
- the port's JPEG, decoded by cv2, within 1 of cv2's own file of the same
  frame, with cv2's DQT tables, Huffman tables and sampling factors (and
  here the same bytes);
- the host library equals its plain Python version, coefficient for
  coefficient, byte for byte and row for row;
- progressive, arithmetic-coded, lossless, 12-bit, CMYK, RGB-coded and
  truncated files raise, naming the file.
"""
import struct
import zlib

import cv2
import numpy as np
import pytest
import torch

from lameness_tpu_torch.video import image as im

QUALITIES = (50, 75, 95)
SAMPLING = {"4:4:4": 0x111111, "4:2:2": 0x211111, "4:4:0": 0x121111,
            "4:2:0": 0x221111}
SIZES = ((48, 64), (37, 53), (61, 90))


def natural(h, w, seed=0):
    """A smooth seeded picture with noise: edges, gradients and texture."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / 7.0 + c) * np.cos(y / 11.0 - c)
                     for c in range(3)], -1)
    return np.clip(base + rng.normal(0, 12, base.shape), 0, 255).astype(
        np.uint8)


def cv2_jpeg(rgb, quality=95, sampling="4:2:0", **extra):
    params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    if rgb.ndim == 3:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    for k, v in extra.items():
        params += [getattr(cv2, k), v]
    ok, buf = cv2.imencode(".jpg", rgb[..., ::-1] if rgb.ndim == 3 else rgb,
                           params)
    assert ok
    return buf.tobytes()


def cv2_read(data: bytes) -> np.ndarray:
    return cv2.imdecode(np.frombuffer(data, np.uint8),
                        cv2.IMREAD_COLOR)[..., ::-1]


def segments(data: bytes):
    """{marker: [segment bodies]} up to the first SOS."""
    out, pos = {}, 2
    while pos < len(data):
        m = data[pos + 1]
        n = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        out.setdefault(m, []).append(data[pos + 4:pos + 2 + n])
        if m == 0xDA:
            break
        pos += 2 + n
    return out


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("sampling", [*SAMPLING, "gray"])
@pytest.mark.parametrize("quality", QUALITIES)
def test_jpeg_decode_matches_cv2(quality, sampling, size):
    rgb = natural(*size, seed=quality)
    src = rgb[..., 1] if sampling == "gray" else rgb
    data = cv2_jpeg(src, quality, sampling)
    got = im.decode_jpeg(data, "cpu", "t.jpg").numpy()
    want = cv2_read(data)
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want).max() <= 1
    if sampling in ("4:4:4", "gray"):
        assert (got == want).mean() == 1.0


@pytest.mark.parametrize("interval", [1, 3])
def test_jpeg_restart_markers(interval):
    rgb = natural(70, 90, seed=interval)
    data = cv2_jpeg(rgb, 90, "4:2:0", IMWRITE_JPEG_RST_INTERVAL=interval)
    assert 0xDD in segments(data)
    assert (im.decode_jpeg(data, "cpu").numpy() == cv2_read(data)).all()


def with_exif(data: bytes, orientation: int, order: str = "II") -> bytes:
    """``data`` with an APP1 Exif segment whose IFD0 holds Orientation."""
    e = "<" if order == "II" else ">"
    tiff = (order.encode() + struct.pack(e + "HI", 42, 8)
            + struct.pack(e + "H", 1)
            + struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack(e + "I", 0))
    body = b"Exif\x00\x00" + tiff
    return data[:2] + struct.pack(">BBH", 0xFF, 0xE1, len(body) + 2) \
        + body + data[2:]


@pytest.mark.parametrize("orientation", range(1, 9))
def test_jpeg_exif_orientation(orientation):
    data = with_exif(cv2_jpeg(natural(24, 40, seed=orientation), 90,
                              "4:4:4"), orientation,
                     "MM" if orientation % 2 else "II")
    got = im.decode_jpeg(data, "cpu").numpy()
    want = cv2_read(data)
    assert got.shape == want.shape
    assert (got == want).all()


# -- PNG ----------------------------------------------------------------------
def png_chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def pack_row(samples, depth: int) -> bytes:
    if depth == 16:
        return b"".join(struct.pack(">H", int(v)) for v in samples)
    if depth == 8:
        return bytes(int(v) for v in samples)
    bits = "".join(format(int(v), f"0{depth}b") for v in samples)
    bits += "0" * (-len(bits) % 8)
    return bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))


def filter_rows(rows, bpp: int, rng) -> bytes:
    """Each row with a random PNG filter (0-4) applied."""
    out, prev = b"", bytes(len(rows[0]))
    for row in rows:
        f = int(rng.integers(0, 5))
        enc = bytearray()
        for i, x in enumerate(row):
            a = row[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            if f == 4:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            else:
                pred = (0, a, b, (a + b) >> 1)[f]
            enc.append((x - pred) & 0xFF)
        out += bytes([f]) + bytes(enc)
        prev = row
    return out


def make_png(samples: np.ndarray, depth: int, ctype: int, interlace=0,
             palette=None, seed=0) -> bytes:
    """A PNG of (H, W, C) integer samples, every row filtered at random."""
    rng = np.random.default_rng(seed)
    h, w, ch = samples.shape
    bpp = max(1, depth * ch // 8)
    passes = im.ADAM7 if interlace else ((0, 0, 1, 1),)
    raw = b""
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            raw += filter_rows([pack_row(r.reshape(-1), depth) for r in sub],
                               bpp, rng)
    extra = png_chunk(b"PLTE", palette.tobytes()) if palette is not None \
        else b""
    return (im.PNG_SIGNATURE
            + png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                             0, 0, interlace))
            + extra + png_chunk(b"IDAT", zlib.compress(raw))
            + png_chunk(b"IEND", b""))


def png_cases():
    rng = np.random.default_rng(7)
    rgb = rng.integers(0, 256, (13, 17, 3), np.uint8)
    cases = {}
    for lvl in (0, 1, 6, 9):
        cases[f"cv2-level{lvl}"] = cv2.imencode(
            ".png", natural(29, 31, lvl)[..., ::-1],
            [cv2.IMWRITE_PNG_COMPRESSION, lvl])[1].tobytes()
    cases["cv2-gray"] = cv2.imencode(".png", rgb[..., 0])[1].tobytes()
    cases["cv2-16bit"] = cv2.imencode(
        ".png", rng.integers(0, 65536, (13, 17, 3)).astype(np.uint16)
    )[1].tobytes()
    cases["cv2-rgba"] = cv2.imencode(
        ".png", np.dstack([rgb, rgb[..., :1]]))[1].tobytes()
    for d in (1, 2, 4, 8, 16):
        cases[f"gray{d}"] = make_png(rng.integers(0, 2 ** d, (7, 11, 1)), d,
                                     0, seed=d)
    pal = rng.integers(0, 256, (256, 3), np.uint8)
    for d in (1, 2, 4, 8):
        cases[f"palette{d}"] = make_png(rng.integers(0, 2 ** d, (7, 11, 1)),
                                        d, 3, palette=pal[:2 ** d], seed=d)
    cases["gray-alpha8"] = make_png(rng.integers(0, 256, (7, 11, 2)), 8, 4)
    cases["gray-alpha16"] = make_png(rng.integers(0, 65536, (7, 11, 2)),
                                     16, 4)
    cases["rgb16"] = make_png(rng.integers(0, 65536, (7, 11, 3)), 16, 2)
    cases["rgba8"] = make_png(rng.integers(0, 256, (7, 11, 4)), 8, 6)
    cases["rgba16"] = make_png(rng.integers(0, 65536, (7, 11, 4)), 16, 6)
    cases["adam7-rgb8"] = make_png(rng.integers(0, 256, (11, 13, 3)), 8, 2,
                                   interlace=1)
    cases["adam7-gray1"] = make_png(rng.integers(0, 2, (11, 13, 1)), 1, 0,
                                    interlace=1)
    cases["adam7-palette4"] = make_png(rng.integers(0, 16, (9, 10, 1)), 4,
                                       3, interlace=1, palette=pal[:16])
    cases["adam7-rgba16"] = make_png(rng.integers(0, 65536, (5, 3, 4)), 16,
                                     6, interlace=1)
    return cases


PNG_CASES = png_cases()


@pytest.mark.parametrize("name", sorted(PNG_CASES))
def test_png_decode_matches_cv2(name):
    data = PNG_CASES[name]
    got = im.decode_png(data, name)
    want = cv2_read(data)
    assert got.shape == want.shape and got.dtype == np.uint8
    assert (got == want).all()
    # the host library's samples are the plain version's, row for row
    plain = im.decode_png(data, name, png_samples=im.plain_png_samples)
    assert (plain == got).all()


# -- encoding -------------------------------------------------------------------
@pytest.mark.parametrize("size", SIZES + ((9, 3),))
@pytest.mark.parametrize("sampling", ["4:4:4", "4:2:2", "4:2:0", "gray"])
def test_jpeg_encode_matches_cv2(sampling, size):
    rgb = natural(*size, seed=3)
    src = rgb[..., 0] if sampling == "gray" else rgb
    ours = im.encode_jpeg(src, 95, "4:2:0" if sampling == "gray"
                          else sampling, device="cpu")
    theirs = cv2_jpeg(src, 95, sampling if sampling != "gray" else "4:2:0")
    a, b = cv2_read(ours), cv2_read(theirs)
    assert np.abs(a.astype(int) - b).max() <= 1
    assert ours == theirs                           # here, byte for byte
    so, st = segments(ours), segments(theirs)
    assert so[0xDB] == st[0xDB]                     # quantisation tables
    assert so[0xC4] == st[0xC4]                     # Huffman tables
    assert so[0xC0] == st[0xC0]                     # size, sampling factors
    # and the port reads its own file as cv2 does
    assert (im.decode_jpeg(ours, "cpu").numpy() == a).all()


def test_encode_default_is_cv2_imwrite(tmp_path):
    """imwrite's defaults are cv2.imwrite's: quality 95, 4:2:0."""
    rgb = natural(40, 56, seed=9)
    im.imwrite(tmp_path / "a.jpg", rgb, device="cpu")
    cv2.imwrite(str(tmp_path / "b.jpg"), rgb[..., ::-1])
    a, b = ((tmp_path / n).read_bytes() for n in ("a.jpg", "b.jpg"))
    assert segments(a)[0xDB] == segments(b)[0xDB]
    assert segments(a)[0xC0] == segments(b)[0xC0]
    assert np.abs(cv2_read(a).astype(int) - cv2_read(b)).max() <= 1


# -- the host library against its plain version ---------------------------------
@pytest.mark.parametrize("case", ["4:2:0", "4:2:2", "4:4:0", "gray",
                                  "restart"])
def test_host_decoder_equals_plain(case):
    rgb = natural(29, 45, seed=11)
    if case == "gray":
        data = cv2_jpeg(rgb[..., 2], 80)
    elif case == "restart":
        data = cv2_jpeg(rgb, 80, "4:2:0", IMWRITE_JPEG_RST_INTERVAL=2)
    else:
        data = cv2_jpeg(rgb, 80, case)
    host = im.parse_jpeg(data, "h.jpg")
    plain = im.parse_jpeg(data, "p.jpg", decode_scan=im.plain_decode_scan)
    for a, b in zip(host.components, plain.components):
        assert a.coefs.shape == b.coefs.shape
        assert (a.coefs == b.coefs).all()


@pytest.mark.parametrize("sampling", ["4:4:4", "4:2:0", "gray"])
def test_host_encoder_equals_plain(sampling):
    rgb = natural(27, 35, seed=12)
    jf = im.jpeg_forward(rgb[..., 0] if sampling == "gray" else rgb, 95,
                         "4:2:0" if sampling == "gray" else sampling,
                         device="cpu")
    assert im.jpeg_bytes(jf) == im.jpeg_bytes(
        jf, encode_scan=im.plain_encode_scan)


def test_standard_tables_are_annex_k():
    """The Huffman tables in the port are the ones cv2's libjpeg writes."""
    st = segments(cv2_jpeg(natural(16, 16), 95))
    want = sorted(st[0xC4])
    got = sorted(bytes([(c << 4) | i] + counts + symbols)
                 for (c, i), (counts, symbols) in im.STD_HUFFMAN.items())
    assert got == want


# -- what the codec does not read ------------------------------------------------
def patch_sof(data: bytes, marker: int, precision: int = 8) -> bytes:
    pos = data.index(b"\xff\xc0")
    return (data[:pos + 1] + bytes([marker]) + data[pos + 2:pos + 4]
            + bytes([precision]) + data[pos + 5:])


def without_app0(data: bytes) -> bytes:
    n = struct.unpack(">H", data[4:6])[0]
    assert data[2:4] == b"\xff\xe0"
    return data[:2] + data[4 + n:]


def rejected_files():
    rgb = natural(24, 32, seed=5)
    base = cv2_jpeg(rgb, 90)
    adobe = b"Adobe" + struct.pack(">HHHB", 100, 0, 0, 0)
    return {
        "progressive": cv2_jpeg(rgb, 90, IMWRITE_JPEG_PROGRESSIVE=1),
        "arithmetic": patch_sof(base, 0xC9),
        "lossless": patch_sof(base, 0xC3),
        "12-bit": patch_sof(base, 0xC1, precision=12),
        "rgb-adobe": (without_app0(base)[:2]
                      + struct.pack(">BBH", 0xFF, 0xEE, len(adobe) + 2)
                      + adobe + without_app0(base)[2:]),
        "truncated": base[:len(base) // 2],
        "not-an-image": b"GIF89a" + bytes(20),
    }


@pytest.mark.parametrize("kind", sorted(rejected_files()))
def test_unsupported_files_raise(tmp_path, kind):
    path = tmp_path / f"{kind}.jpg"
    path.write_bytes(rejected_files()[kind])
    with pytest.raises(im.ImageError, match=str(path)):
        im.imread(path, "cpu")


def test_cmyk_header_raises():
    data = cv2_jpeg(natural(16, 16), 90)
    pos = data.index(b"\xff\xc0")
    n = struct.unpack(">H", data[pos + 2:pos + 4])[0]
    comps = data[pos + 10:pos + 2 + n] + bytes([4, 0x11, 1])
    sof = struct.pack(">BBHBHHB", 0xFF, 0xC0, 8 + 3 * 4, 8, 16, 16, 4) \
        + comps
    with pytest.raises(im.ImageError, match="4-component"):
        im.parse_jpeg(data[:pos] + sof + data[pos + 2 + n:], "cmyk.jpg")


def patch_sos(data: bytes, entries, ns=None) -> bytes:
    """``data`` with its SOS header rewritten to name ``entries`` (component
    id, Td << 4 | Ta), its count byte ``ns`` (default: the entries')."""
    pos = data.index(b"\xff\xda")
    n = struct.unpack(">H", data[pos + 2:pos + 4])[0]
    body = (bytes([len(entries) if ns is None else ns])
            + b"".join(bytes(e) for e in entries) + b"\x00\x3f\x00")
    return (data[:pos] + b"\xff\xda" + struct.pack(">H", len(body) + 2)
            + body + data[pos + 2 + n:])


def malformed_scans():
    rgb = natural(24, 32, seed=7)
    base, gray = cv2_jpeg(rgb, 90), cv2_jpeg(rgb[..., 0], 90)
    ok = [(1, 0x00), (2, 0x11), (3, 0x11)]
    assert patch_sos(base, ok) == base
    return {
        "dc-table-15": patch_sos(base, [(1, 0xF0)] + ok[1:]),
        "ac-table-15": patch_sos(base, [(1, 0x0F)] + ok[1:]),
        "dc-table-4": patch_sos(base, [(1, 0x40)] + ok[1:]),
        "five-components": patch_sos(base, ok + ok[:2]),
        "no-components": patch_sos(base, []),
        "component-twice": patch_sos(base, [ok[0], ok[0], ok[2]]),
        "count-past-segment": patch_sos(base, ok, ns=200),
        "gray-two-components": patch_sos(gray, [(1, 0x00), (1, 0x00)]),
    }


@pytest.mark.parametrize("kind", sorted(malformed_scans()))
def test_malformed_scan_header_raises(tmp_path, kind):
    """SOS fields the host library would index by (table ids, the component
    count, a component twice) are checked against the frame; libjpeg
    rejects the same files."""
    data = malformed_scans()[kind]
    assert cv2.imdecode(np.frombuffer(data, np.uint8),
                        cv2.IMREAD_COLOR) is None
    path = tmp_path / f"{kind}.jpg"
    path.write_bytes(data)
    with pytest.raises(im.ImageError, match=str(path)):
        im.imread(path, "cpu")
    with pytest.raises(im.ImageError, match=kind):
        im.parse_jpeg(data, kind, decode_scan=im.plain_decode_scan)


def out_of_range_scans():
    blocks = np.zeros((8, 8, 64), np.int16)     # room for any sampling

    def comp(**kw):
        return im.ScanComponent(**{"coefs": blocks, "h": 1, "v": 1, "dc": 0,
                                   "ac": 0, **kw})
    return {"dc-15": [comp(dc=15)], "ac-4": [comp(ac=4)],
            "dc-negative": [comp(dc=-1)], "h-0": [comp(h=0)],
            "v-5": [comp(v=5)], "five": [comp() for _ in range(5)],
            "none": []}


@pytest.mark.parametrize("entry", ["host", "plain"])
@pytest.mark.parametrize("case", sorted(out_of_range_scans()))
def test_scan_entries_check_their_arguments(entry, case):
    """The library's entries return an error on a scan description out of
    range before they index anything, and the plain versions raise the
    same error."""
    comps = out_of_range_scans()[case]
    tables = im.HuffmanTables.standard()
    decode = getattr(im, f"{entry}_decode_scan")
    encode = getattr(im, f"{entry}_encode_scan")
    with pytest.raises(im.ImageError, match="out of range"):
        decode(np.zeros(64, np.uint8), comps, tables, 1, 1, 0)
    with pytest.raises(im.ImageError, match="out of range"):
        encode(comps, tables, 1, 1)


def test_host_scan_checks_its_buffers():
    """The bound the library cannot see: a block buffer smaller than the
    scan's MCUs is refused before the call."""
    comp = im.ScanComponent(np.zeros((1, 2, 64), np.int16), 2, 2, 0, 0)
    tables = im.HuffmanTables.standard()
    with pytest.raises(ValueError, match="do not hold"):
        im.host_decode_scan(np.zeros(64, np.uint8), [comp], tables, 1, 1, 0)
    with pytest.raises(ValueError, match="do not hold"):
        im.host_encode_scan([comp], tables, 1, 1)


def test_oversized_headers_raise():
    """A header claiming more than cv2's 2^30 pixels raises before any
    buffer is made."""
    data = cv2_jpeg(natural(16, 16), 90)
    pos = data.index(b"\xff\xc0")
    big = data[:pos + 5] + struct.pack(">HH", 65535, 65535) + data[pos + 9:]
    with pytest.raises(im.ImageError, match="pixels"):
        im.parse_jpeg(big, "big.jpg")
    ihdr = struct.pack(">IIBBBBB", 1 << 16, 1 << 15, 8, 2, 0, 0, 0)
    png = (im.PNG_SIGNATURE + png_chunk(b"IHDR", ihdr)
           + png_chunk(b"IDAT", zlib.compress(b"")) + png_chunk(b"IEND", b""))
    with pytest.raises(im.ImageError, match="pixels"):
        im.decode_png(png, "big.png")


# -- the file API -----------------------------------------------------------------
def test_imread_imwrite_and_size(tmp_path):
    rgb = natural(33, 47, seed=4)
    im.imwrite(tmp_path / "a.png", rgb)
    assert (im.imread(tmp_path / "a.png", "cpu").numpy() == rgb).all()
    assert (cv2.imread(str(tmp_path / "a.png"))[..., ::-1] == rgb).all()
    im.imwrite(tmp_path / "b.jpg", torch.from_numpy(rgb))  # a CPU tensor
    got = im.imread(tmp_path / "b.jpg", "cpu").numpy()
    assert (got == cv2.imread(str(tmp_path / "b.jpg"))[..., ::-1]).all()
    for name in ("a.png", "b.jpg"):
        assert im.image_size(tmp_path / name) == (47, 33)
    # the stored size, as PIL gives it, not the EXIF turn
    (tmp_path / "c.jpg").write_bytes(with_exif(
        (tmp_path / "b.jpg").read_bytes(), 6))
    assert im.image_size(tmp_path / "c.jpg") == (47, 33)
    assert im.imread(tmp_path / "c.jpg", "cpu").shape == (47, 33, 3)
    with pytest.raises(im.ImageError):
        im.imwrite(tmp_path / "d.bmp", rgb, device="cpu")
    with pytest.raises(FileNotFoundError):
        im.imread(tmp_path / "missing.jpg", "cpu")


def test_imread_needs_a_card_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    im.imwrite(tmp_path / "a.png", natural(8, 8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        im.imread(tmp_path / "a.png")


@pytest.mark.parametrize("src,dst", [((96, 96), (64, 64)), ((37, 53),
                                                            (320, 320))])
def test_resize_is_cv2_inter_linear(src, dst):
    rgb = natural(*src, seed=6)
    got = im.resize(rgb, dst)
    want = cv2.resize(rgb, dst)
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want).max() <= 1
