"""The port's image codec: baseline JPEG and PNG without OpenCV or PIL.

The JAX package reads and writes dataset images with ``cv2.imread``,
``cv2.imwrite``, ``cv2.resize`` and ``PIL.Image.size``
(``lameness_tpu/pipeline/pose_training.py:120-147`` and the scripts under
``scripts/``); the card's machine has neither library.  This module gives
the same pixels:

- **JPEG decode** as OpenCV's libjpeg-turbo decodes (ISLOW integer IDCT,
  fancy upsampling, fixed-point YCbCr -> RGB, the EXIF orientation applied
  as ``cv2.imread(IMREAD_COLOR)`` applies it).  Baseline and extended
  sequential 8-bit Huffman files, gray or YCbCr at 4:4:4, 4:2:2, 4:4:0 and
  4:2:0, with or without restart markers.  Progressive, arithmetic-coded,
  lossless, hierarchical, 12-bit, CMYK and RGB-coded (Adobe transform 0)
  files raise :class:`ImageError` with the file's name.
- **PNG decode**: bit depths 1-16; gray, gray + alpha, RGB, RGBA and
  palette; non-interlaced and Adam7.  Alpha is dropped and 16-bit samples
  are taken ``>> 8``, as ``cv2.imread(IMREAD_COLOR)`` gives them.
- **JPEG encode** as ``cv2.imwrite`` writes by default: JFIF, the IJG
  tables scaled to the quality (95), 4:2:0, the Annex K Huffman tables,
  libjpeg's RGB -> YCbCr, h2v2 downsampling and ISLOW forward DCT.  PNG is
  written unfiltered through zlib.

The work is split in two.  The transforms (dequantisation, IDCT,
upsampling, colour conversion, and the inverses for encoding) are int32
tensor ops over all blocks at once on the caller's device, the card by
default: integer arithmetic, so the card's pixels equal the CPU's bit for
bit.  The serial bit work (Huffman coding, PNG unfiltering) runs on the
host in ``csrc/host/image_codec.cpp`` (``ops/_host.py``).  Each of its
entries has a plain Python version here (``plain_*``) that the tests hold
it against; the codec itself never uses them.
"""
from __future__ import annotations

import ctypes
import struct
import zlib
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.device import resolve_device
from ..ops import _host

# zigzag position -> natural (row-major) index of an 8x8 block
NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63],
    np.int64)

# the IJG base quantisation tables (natural order), jcparam.c
STD_LUMA_QT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
    np.int64)
STD_CHROMA_QT = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
    + [99] * 32, np.int64)

# the Annex K Huffman tables (counts of codes of length 1..16, symbols),
# as libjpeg uses them when optimize_coding is off
_AC_LUMA_VALS = [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa]
_AC_CHROMA_VALS = [
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa]
# (class, id) -> (counts, symbols); class 0 DC, 1 AC
STD_HUFFMAN = {
    (0, 0): ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12))),
    (1, 0): ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125],
             _AC_LUMA_VALS),
    (0, 1): ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12))),
    (1, 1): ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119],
             _AC_CHROMA_VALS),
}

# sampling factors (h, v) of Y, Cb, Cr by cv2's names
SUBSAMPLING = {"4:4:4": ((1, 1), (1, 1), (1, 1)),
               "4:2:2": ((2, 1), (1, 1), (1, 1)),
               "4:2:0": ((2, 2), (1, 1), (1, 1))}

# libjpeg's fixed-point constants: FIX(x) = round(x * 2^13) (the DCTs),
# round(x * 2^16) (the colour conversions)
CONST_BITS = 13
PASS1_BITS = 2
F_0_298, F_0_390, F_0_541, F_0_765 = 2446, 3196, 4433, 6270
F_0_899, F_1_175, F_1_501, F_1_847 = 7373, 9633, 12299, 15137
F_1_961, F_2_053, F_2_562, F_3_072 = 16069, 16819, 20995, 25172


def _fix16(x: float) -> int:
    return int(x * 65536 + 0.5)


class ImageError(ValueError):
    """A file the codec cannot read or write; the message names it."""


# ---------------------------------------------------------------------------
# entropy coding and PNG rows: the host library and its plain version
# ---------------------------------------------------------------------------
_ERRORS = {-1: "a Huffman table is not a prefix code",
           -2: "a Huffman code matches no symbol (corrupt data)",
           -3: "a restart marker is missing or out of order",
           -4: "the entropy-coded data ends early (truncated file)",
           -5: "a coefficient has no Huffman code in the table",
           -6: "the output buffer is too small",
           -7: "a row's PNG filter type is not 0-4",
           -8: "the PNG image data is shorter than the image",
           -9: "a scan's component count, sampling or table ids are out of "
               "range"}

# cv2's cap on the pixels of an image it reads (CV_IO_MAX_IMAGE_PIXELS)
MAX_PIXELS = 1 << 30


@dataclass
class HuffmanTables:
    """Up to four DC and four AC tables, laid out as the host library takes
    them: row ``4 * class + id`` holds 16 counts and 256 symbols."""
    bits: np.ndarray = field(
        default_factory=lambda: np.zeros((8, 16), np.uint8))
    vals: np.ndarray = field(
        default_factory=lambda: np.zeros((8, 256), np.uint8))

    def set(self, cls: int, ident: int, counts, symbols) -> None:
        self.bits[4 * cls + ident] = counts
        self.vals[4 * cls + ident] = 0
        self.vals[4 * cls + ident, :len(symbols)] = symbols

    @classmethod
    def standard(cls) -> "HuffmanTables":
        t = cls()
        for (c, i), (counts, symbols) in STD_HUFFMAN.items():
            t.set(c, i, counts, symbols)
        return t


@dataclass
class ScanComponent:
    """One component of a scan: its blocks (rows, cols, 64) int16 in
    natural order, its MCU footprint (h, v) and its two tables."""
    coefs: np.ndarray
    h: int
    v: int
    dc: int
    ac: int


def _scan_in_range(comps: Sequence[ScanComponent]) -> bool:
    """What the host library checks of a scan before it indexes anything:
    1-4 components, sampling 1-4, table ids 0-3."""
    return 1 <= len(comps) <= 4 and all(
        1 <= c.h <= 4 and 1 <= c.v <= 4 and 0 <= c.dc <= 3 and 0 <= c.ac <= 3
        for c in comps)


def _comp_array(comps: Sequence[ScanComponent], mcus_x: int, mcus_y: int):
    spec = np.array([[c.h, c.v, c.dc, c.ac, c.coefs.shape[1]] for c in comps],
                    np.int32).reshape(-1, 5)
    for c in comps:
        if c.coefs.dtype != np.int16 or not c.coefs.flags.c_contiguous:
            raise ValueError("scan blocks must be C-contiguous int16")
        # the one bound the library cannot see: each buffer holds the scan
        if c.coefs.ndim != 3 or c.coefs.shape[0] < mcus_y * c.v \
                or c.coefs.shape[1] < mcus_x * c.h or c.coefs.shape[2] != 64:
            raise ValueError(f"scan blocks {c.coefs.shape} do not hold "
                             f"{mcus_y}x{mcus_x} MCUs of {c.v}x{c.h}")
    ptrs = (ctypes.c_void_p * len(comps))(*[c.coefs.ctypes.data
                                            for c in comps])
    return spec, ptrs


def _codec_lib() -> ctypes.CDLL:
    lib = _host.library("image_codec")
    if not getattr(lib, "_typed", False):
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
        lib.lt_jpeg_decode_scan.argtypes = [p, i64, i32, p, p, p, p, i32,
                                            i32, i32, p]
        lib.lt_jpeg_decode_scan.restype = ctypes.c_int
        lib.lt_jpeg_encode_scan.argtypes = [i32, p, p, p, p, i32, i32, p, i64]
        lib.lt_jpeg_encode_scan.restype = ctypes.c_int64
        lib.lt_png_decode.argtypes = [p, i64, i32, i32, i32, i32, i32, p, p]
        lib.lt_png_decode.restype = ctypes.c_int
        lib._typed = True
    return lib


def host_decode_scan(data: np.ndarray, comps: Sequence[ScanComponent],
                     tables: HuffmanTables, mcus_x: int, mcus_y: int,
                     restart: int) -> int:
    """Huffman-decode one scan's entropy-coded bytes (``data``, uint8, from
    just after the SOS header) into ``comps``' blocks; returns the offset of
    the first byte not consumed.  Raises :class:`ImageError` on corrupt
    data."""
    data = np.ascontiguousarray(data, np.uint8)
    spec, ptrs = _comp_array(comps, mcus_x, mcus_y)
    end = ctypes.c_int64(0)
    rc = _codec_lib().lt_jpeg_decode_scan(
        data.ctypes.data, data.size, len(comps), spec.ctypes.data, ptrs,
        tables.bits.ctypes.data, tables.vals.ctypes.data, mcus_x, mcus_y,
        restart, ctypes.byref(end))
    if rc:
        raise ImageError(_ERRORS.get(rc, f"error {rc}"))
    return end.value


def host_encode_scan(comps: Sequence[ScanComponent], tables: HuffmanTables,
                     mcus_x: int, mcus_y: int) -> bytes:
    """Huffman-encode one scan of quantised blocks: the entropy-coded bytes,
    stuffed, padded with 1-bits."""
    spec, ptrs = _comp_array(comps, mcus_x, mcus_y)
    blocks = sum(c.coefs.shape[0] * c.coefs.shape[1] for c in comps)
    out = np.empty(blocks * 512 + 1024, np.uint8)
    n = _codec_lib().lt_jpeg_encode_scan(
        len(comps), spec.ctypes.data, ptrs, tables.bits.ctypes.data,
        tables.vals.ctypes.data, mcus_x, mcus_y, out.ctypes.data, out.size)
    if n < 0:
        raise ImageError(_ERRORS.get(int(n), f"error {n}"))
    return out[:n].tobytes()


def host_png_samples(raw: bytes, width: int, height: int, depth: int,
                     channels: int, interlace: int) -> np.ndarray:
    """The inflated IDAT stream -> (height, width, channels) uint16 samples
    (unfiltered, unpacked, Adam7 passes put in place)."""
    out = np.zeros((height, width, channels), np.uint16)
    rowbytes = (width * depth * channels + 7) // 8
    scratch = np.zeros(2 * rowbytes + 16, np.uint8)
    buf = np.frombuffer(raw, np.uint8)
    rc = _codec_lib().lt_png_decode(buf.ctypes.data, buf.size, width, height,
                                    depth, channels, interlace,
                                    out.ctypes.data, scratch.ctypes.data)
    if rc:
        raise ImageError(_ERRORS.get(rc, f"error {rc}"))
    return out


def _decode_table(counts, symbols):
    maxcode, valoffset = [-1] * 18, [0] * 17
    code = k = 0
    for length in range(1, 17):
        n = int(counts[length - 1])
        valoffset[length] = k - code
        code += n
        k += n
        if code > (1 << length) or k > 256:
            raise ImageError(_ERRORS[-1])
        maxcode[length] = code - 1 if n else -1
        code <<= 1
    return maxcode, valoffset, [int(s) for s in symbols]


class _PlainBits:
    """Bit-at-a-time reader of an entropy-coded segment: stuffed 0xFF00 is
    0xFF, fill bytes are skipped, a marker ends the data."""

    def __init__(self, data):
        self.d, self.p, self.byte, self.n = data, 0, 0, 0

    def _next_byte(self) -> int:
        d, p = self.d, self.p
        if p < len(d) and d[p] != 0xFF:
            self.p = p + 1
            return int(d[p])
        q = p + 1
        while q < len(d) and d[q] == 0xFF:
            q += 1
        if p < len(d) and q < len(d) and d[q] == 0:
            self.p = q + 1
            return 0xFF
        raise ImageError(_ERRORS[-4])

    def bit(self) -> int:
        if self.n == 0:
            self.byte, self.n = self._next_byte(), 8
        self.n -= 1
        return (self.byte >> self.n) & 1

    def bits(self, k: int) -> int:
        v = 0
        for _ in range(k):
            v = (v << 1) | self.bit()
        return v

    def symbol(self, table) -> int:
        maxcode, valoffset, vals = table
        code = 0
        for length in range(1, 17):
            code = (code << 1) | self.bit()
            if code <= maxcode[length]:
                return vals[code + valoffset[length]]
        raise ImageError(_ERRORS[-2])


def _extend(v: int, s: int) -> int:
    return v - (1 << s) + 1 if v < (1 << (s - 1)) else v


def plain_decode_scan(data: np.ndarray, comps: Sequence[ScanComponent],
                      tables: HuffmanTables, mcus_x: int, mcus_y: int,
                      restart: int) -> int:
    """:func:`host_decode_scan` one bit at a time in Python (the tests'
    reference; about a second for a 640x480 image)."""
    if not _scan_in_range(comps):
        raise ImageError(_ERRORS[-9])
    br = _PlainBits(np.asarray(data, np.uint8))
    dec = {t: _decode_table(tables.bits[t], tables.vals[t])
           for c in comps for t in (c.dc, 4 + c.ac)}
    pred = [0] * len(comps)
    rst = 0
    for m in range(mcus_x * mcus_y):
        if restart and m and m % restart == 0:
            br.n = 0
            q = br.p
            while q < len(br.d) and br.d[q] == 0xFF:
                q += 1
            if q == br.p or q >= len(br.d) or br.d[q] != 0xD0 + rst:
                raise ImageError(_ERRORS[-3])
            br.p = q + 1
            rst = (rst + 1) & 7
            pred = [0] * len(comps)
        mx, my = m % mcus_x, m // mcus_x
        for ci, c in enumerate(comps):
            for by in range(c.v):
                for bx in range(c.h):
                    blk = c.coefs[my * c.v + by, mx * c.h + bx]
                    blk[:] = 0
                    s = br.symbol(dec[c.dc])
                    if s > 15:
                        raise ImageError(_ERRORS[-2])
                    if s:
                        pred[ci] += _extend(br.bits(s), s)
                    blk[0] = ((pred[ci] + 32768) & 0xFFFF) - 32768
                    k = 1
                    while k < 64:
                        rs = br.symbol(dec[4 + c.ac])
                        r, s = rs >> 4, rs & 15
                        if s:
                            k += r
                            blk[NATURAL[k] if k < 64 else 63] = \
                                _extend(br.bits(s), s)
                        elif r == 15:
                            k += 15
                        else:
                            break
                        k += 1
    return br.p


def plain_encode_scan(comps: Sequence[ScanComponent], tables: HuffmanTables,
                      mcus_x: int, mcus_y: int) -> bytes:
    """:func:`host_encode_scan` in Python (the tests' reference)."""
    if not _scan_in_range(comps):
        raise ImageError(_ERRORS[-9])
    codes: Dict[int, Dict[int, Tuple[int, int]]] = {}
    for t in {t for c in comps for t in (c.dc, 4 + c.ac)}:
        code, k, table = 0, 0, {}
        for length in range(1, 17):
            for _ in range(int(tables.bits[t, length - 1])):
                table[int(tables.vals[t, k])] = (code, length)
                code += 1
                k += 1
            code <<= 1
        codes[t] = table
    out = bytearray()
    acc, nacc = 0, 0

    def put(v: int, nb: int) -> None:
        nonlocal acc, nacc
        acc = (acc << nb) | (v & ((1 << nb) - 1))
        nacc += nb
        while nacc >= 8:
            b = (acc >> (nacc - 8)) & 0xFF
            nacc -= 8
            out.append(b)
            if b == 0xFF:
                out.append(0)
        acc &= (1 << nacc) - 1

    def sym(t: int, s: int) -> None:
        if s not in codes[t]:
            raise ImageError(_ERRORS[-5])
        put(*codes[t][s])

    pred = [0] * len(comps)
    for m in range(mcus_x * mcus_y):
        mx, my = m % mcus_x, m // mcus_x
        for ci, c in enumerate(comps):
            for by in range(c.v):
                for bx in range(c.h):
                    blk = [int(x) for x in
                           c.coefs[my * c.v + by, mx * c.h + bx][NATURAL]]
                    diff = blk[0] - pred[ci]
                    pred[ci] = blk[0]
                    nb = abs(diff).bit_length()
                    sym(c.dc, nb)
                    if nb:
                        put(diff - 1 if diff < 0 else diff, nb)
                    run = 0
                    for v in blk[1:]:
                        if v == 0:
                            run += 1
                            continue
                        while run > 15:
                            sym(4 + c.ac, 0xF0)
                            run -= 16
                        nb = abs(v).bit_length()
                        sym(4 + c.ac, (run << 4) | nb)
                        put(v - 1 if v < 0 else v, nb)
                        run = 0
                    if run:
                        sym(4 + c.ac, 0x00)
    if nacc:
        put(0x7F, 8 - nacc)
    return bytes(out)


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def plain_png_samples(raw: bytes, width: int, height: int, depth: int,
                      channels: int, interlace: int) -> np.ndarray:
    """:func:`host_png_samples` in Python (the tests' reference)."""
    out = np.zeros((height, width, channels), np.uint16)
    pix_bits = depth * channels
    bpp = max(1, pix_bits // 8)
    pos = 0
    for x0, y0, dx, dy in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        pw = (width - x0 + dx - 1) // dx if width > x0 else 0
        ph = (height - y0 + dy - 1) // dy if height > y0 else 0
        if pw == 0 or ph == 0:
            continue
        rowbytes = (pw * pix_bits + 7) // 8
        prev = [0] * rowbytes
        for r in range(ph):
            if pos + 1 + rowbytes > len(raw):
                raise ImageError(_ERRORS[-8])
            f, src = raw[pos], raw[pos + 1:pos + 1 + rowbytes]
            pos += 1 + rowbytes
            cur = [0] * rowbytes
            for i in range(rowbytes):
                a = cur[i - bpp] if i >= bpp else 0
                b = prev[i]
                c = prev[i - bpp] if i >= bpp else 0
                if f == 0:
                    pred = 0
                elif f == 1:
                    pred = a
                elif f == 2:
                    pred = b
                elif f == 3:
                    pred = (a + b) >> 1
                elif f == 4:
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                else:
                    raise ImageError(_ERRORS[-7])
                cur[i] = (src[i] + pred) & 0xFF
            for col in range(pw):
                for ch in range(channels):
                    s = col * channels + ch
                    if depth == 8:
                        v = cur[s]
                    elif depth == 16:
                        v = (cur[2 * s] << 8) | cur[2 * s + 1]
                    else:
                        bit = s * depth
                        v = (cur[bit >> 3] >> (8 - depth - (bit & 7))) \
                            & ((1 << depth) - 1)
                    out[y0 + r * dy, x0 + col * dx, ch] = v
            prev = cur
    return out


# ---------------------------------------------------------------------------
# JPEG: the file and its markers (host)
# ---------------------------------------------------------------------------
@dataclass
class JpegComponent:
    ident: int
    h: int
    v: int
    tq: int
    coefs: Optional[np.ndarray] = None    # (rows, cols, 64) int16, natural


@dataclass
class JpegFile:
    """A JPEG between its bytes and its pixels: the frame, the quantisation
    tables (natural order) and each component's quantised blocks."""
    width: int
    height: int
    components: List[JpegComponent]
    qtables: Dict[int, np.ndarray]
    orientation: int = 1

    @property
    def max_h(self) -> int:
        return max(c.h for c in self.components)

    @property
    def max_v(self) -> int:
        return max(c.v for c in self.components)

    def blocks_in(self, c: JpegComponent) -> Tuple[int, int]:
        """The component's blocks across and down that hold image data."""
        return (-(-self.width * c.h // (self.max_h * 8)),
                -(-self.height * c.v // (self.max_v * 8)))

    def samples_in(self, c: JpegComponent) -> Tuple[int, int]:
        """The component's samples across and down (libjpeg's downsampled
        width and height)."""
        return (-(-self.width * c.h // self.max_h),
                -(-self.height * c.v // self.max_v))

    @property
    def mcus(self) -> Tuple[int, int]:
        return (-(-self.width // (self.max_h * 8)),
                -(-self.height // (self.max_v * 8)))


_SOF_KINDS = {0xC2: "progressive", 0xC3: "lossless",
              0xC5: "hierarchical", 0xC6: "hierarchical progressive",
              0xC7: "hierarchical lossless", 0xC9: "arithmetic-coded",
              0xCA: "arithmetic-coded progressive",
              0xCB: "arithmetic-coded lossless",
              0xCD: "arithmetic-coded hierarchical",
              0xCE: "arithmetic-coded hierarchical progressive",
              0xCF: "arithmetic-coded hierarchical lossless"}


def exif_orientation(tiff: bytes) -> int:
    """The Orientation tag (0x0112) of IFD0 of an EXIF TIFF structure, 1
    when there is none or it cannot be read."""
    if len(tiff) < 8 or tiff[:2] not in (b"II", b"MM"):
        return 1
    e = "<" if tiff[:2] == b"II" else ">"
    ifd = struct.unpack(e + "I", tiff[4:8])[0]
    if ifd + 2 > len(tiff):
        return 1
    n = struct.unpack(e + "H", tiff[ifd:ifd + 2])[0]
    for i in range(n):
        at = ifd + 2 + 12 * i
        if at + 12 > len(tiff):
            break
        tag, typ = struct.unpack(e + "HH", tiff[at:at + 4])
        if tag == 0x0112 and typ == 3:
            value = struct.unpack(e + "H", tiff[at + 8:at + 10])[0]
            return value if 1 <= value <= 8 else 1
    return 1


def parse_jpeg(data: bytes, name: str = "<bytes>",
               decode_scan=host_decode_scan) -> JpegFile:
    """The host half of decoding: the markers, and each scan's blocks by
    ``decode_scan`` (the host library; the tests pass the plain version).
    Raises :class:`ImageError` naming ``name`` on any file the decoder does
    not take."""
    def fail(why: str):
        raise ImageError(f"{name}: {why}")

    buf = np.frombuffer(data, np.uint8)
    if data[:2] != b"\xff\xd8":
        fail("not a JPEG file (no SOI marker)")
    pos, n = 2, len(data)
    frame: Optional[JpegFile] = None
    tables = HuffmanTables()
    qtables: Dict[int, np.ndarray] = {}
    restart, orientation = 0, 1
    adobe: Optional[int] = None
    jfif = False
    scanned = set()
    while True:
        if pos >= n:
            if scanned:
                break          # no EOI: libjpeg warns and keeps the image
            fail("truncated before the first scan")
        if data[pos] != 0xFF:
            fail(f"corrupt JPEG (no marker at byte {pos})")
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            fail("truncated marker")
        m = data[pos]
        pos += 1
        if m == 0xD9:
            break
        if 0xD0 <= m <= 0xD7 or m == 0x01:
            continue
        if pos + 2 > n:
            fail("truncated marker segment")
        seglen = struct.unpack(">H", data[pos:pos + 2])[0]
        seg = data[pos + 2:pos + seglen]
        if seglen < 2 or len(seg) != seglen - 2:
            fail("truncated marker segment")
        pos += seglen
        if m == 0xDB:
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                size = 128 if pq else 64
                raw = np.frombuffer(seg[i + 1:i + 1 + size],
                                    ">u2" if pq else np.uint8)
                if raw.size != 64 or tq > 3:
                    fail("corrupt DQT segment")
                q = np.zeros(64, np.int32)
                q[NATURAL] = raw
                qtables[tq] = q
                i += 1 + size
        elif m == 0xC4:
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                counts = list(seg[i + 1:i + 17])
                total = sum(counts)
                symbols = list(seg[i + 17:i + 17 + total])
                if tc > 1 or th > 3 or len(counts) != 16 \
                        or len(symbols) != total or total > 256:
                    fail("corrupt DHT segment")
                tables.set(tc, th, counts, symbols)
                i += 17 + total
        elif m in (0xC0, 0xC1):
            if frame is not None:
                fail("more than one frame")
            if len(seg) < 6:
                fail("corrupt SOF segment")
            if seg[0] != 8:
                fail(f"{seg[0]}-bit JPEG is not supported (8-bit only)")
            h, w, nc = struct.unpack(">HHB", seg[1:6])
            if h == 0 or w == 0:
                fail("zero image size (DNL) is not supported")
            if w * h > MAX_PIXELS:
                fail(f"{w}x{h} is more than {MAX_PIXELS} pixels")
            if nc not in (1, 3):
                fail(f"{nc}-component (CMYK/YCCK) JPEG is not supported")
            if len(seg) != 6 + 3 * nc:
                fail("corrupt SOF segment")
            comps = [JpegComponent(seg[6 + 3 * k], seg[7 + 3 * k] >> 4,
                                   seg[7 + 3 * k] & 15, seg[8 + 3 * k])
                     for k in range(nc)]
            if any(not 1 <= c.h <= 4 or not 1 <= c.v <= 4 for c in comps):
                fail("bad sampling factors")
            if len({c.ident for c in comps}) != nc:
                fail("two components share an id")
            frame = JpegFile(w, h, comps, qtables)
            mx, my = frame.mcus
            for c in comps:
                bw, bh = ((mx * c.h, my * c.v) if nc > 1
                          else frame.blocks_in(c))
                c.coefs = np.zeros((bh, bw, 64), np.int16)
        elif m in _SOF_KINDS:
            fail(f"{_SOF_KINDS[m]} JPEG is not supported (baseline only)")
        elif m == 0xDD:
            if len(seg) != 2:
                fail("corrupt DRI segment")
            restart = struct.unpack(">H", seg)[0]
        elif m == 0xE0 and seg[:5] == b"JFIF\x00":
            jfif = True
        elif m == 0xE1 and seg[:6] == b"Exif\x00\x00":
            orientation = exif_orientation(seg[6:])
        elif m == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe = seg[11]
        elif m == 0xDA:
            if frame is None:
                fail("scan before the frame header")
            ns = seg[0] if seg else 0
            if not 1 <= ns <= min(4, len(frame.components)) \
                    or len(seg) != 4 + 2 * ns:
                fail(f"corrupt SOS segment ({ns} components)")
            by_id = {c.ident: c for c in frame.components}
            members = []
            for k in range(ns):
                c = by_id.get(seg[1 + 2 * k])
                if c is None:
                    fail("scan names an unknown component")
                if any(c is other for other, _, _ in members):
                    fail("scan names a component twice")
                td, ta = seg[2 + 2 * k] >> 4, seg[2 + 2 * k] & 15
                if td > 3 or ta > 3:
                    fail(f"scan names Huffman table {max(td, ta)} (0-3 only)")
                members.append((c, td, ta))
            if ns > 1 and sum(c.h * c.v for c, _, _ in members) > 10:
                fail("more than 10 blocks in an MCU")
            ss, se, ahal = seg[1 + 2 * ns:4 + 2 * ns]
            if (ss, se, ahal) != (0, 63, 0):
                fail("progressive scan is not supported (baseline only)")
            if ns == 1:
                c, td, ta = members[0]
                mcus_x, mcus_y = frame.blocks_in(c)
                scan = [ScanComponent(c.coefs, 1, 1, td, ta)]
            else:
                mcus_x, mcus_y = frame.mcus
                scan = [ScanComponent(c.coefs, c.h, c.v, td, ta)
                        for c, td, ta in members]
            try:
                end = decode_scan(buf[pos:], scan, tables, mcus_x, mcus_y,
                                  restart)
            except ImageError as exc:
                fail(str(exc))
            scanned.update(c.ident for c, _, _ in members)
            pos += end
            # on to the next marker: past the padding and any RSTn
            while pos < n and not (
                    data[pos] == 0xFF and pos + 1 < n
                    and data[pos + 1] not in (0x00, 0xFF)
                    and not 0xD0 <= data[pos + 1] <= 0xD7):
                pos += 1
    if frame is None:
        fail("no frame header")
    if len(scanned) != len(frame.components):
        fail("a component has no scan")
    for c in frame.components:
        if c.tq not in qtables:
            fail(f"quantisation table {c.tq} is missing")
    ids = tuple(c.ident for c in frame.components)
    if len(ids) == 3 and not jfif and (
            adobe == 0 or (adobe is None and ids == (82, 71, 66))):
        fail("RGB-coded (Adobe transform 0) JPEG is not supported")
    frame.orientation = orientation
    return frame


# ---------------------------------------------------------------------------
# JPEG: the transforms (device)
# ---------------------------------------------------------------------------
def _descale(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x + (1 << (n - 1))) >> n


def _idct_1d(c: List[torch.Tensor], shift: int) -> List[torch.Tensor]:
    """One pass of libjpeg's jpeg_idct_islow (jidctint.c) over eight inputs
    (each a tensor of the same shape), descaled by ``shift``."""
    z2, z3 = c[2], c[6]
    z1 = (z2 + z3) * F_0_541
    tmp2 = z1 + z3 * -F_1_847
    tmp3 = z1 + z2 * F_0_765
    tmp0 = (c[0] + c[4]) << CONST_BITS
    tmp1 = (c[0] - c[4]) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = c[7], c[5], c[3], c[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * F_1_175
    t0, t1 = t0 * F_0_298, t1 * F_2_053
    t2, t3 = t2 * F_3_072, t3 * F_1_501
    z1, z2 = z1 * -F_0_899, z2 * -F_2_562
    z3, z4 = z3 * -F_1_961 + z5, z4 * -F_0_390 + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    return [_descale(v, shift) for v in (
        tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
        tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)]


def idct_islow(coefs: torch.Tensor) -> torch.Tensor:
    """(N, 8, 8) int32 dequantised coefficients -> (N, 8, 8) uint8 samples:
    libjpeg's ISLOW IDCT (CONST_BITS 13, PASS1_BITS 2), saturated to 0..255
    as libjpeg-turbo's SIMD routine saturates."""
    ws = torch.stack(_idct_1d(list(coefs.unbind(1)),
                              CONST_BITS - PASS1_BITS), 1)
    out = torch.stack(_idct_1d(list(ws.unbind(2)),
                               CONST_BITS + PASS1_BITS + 3), 2)
    return (out + 128).clamp_(0, 255)


def _shifted(x: torch.Tensor, dim: int, step: int) -> torch.Tensor:
    """``x`` moved one sample along ``dim`` (step -1: each sample's
    predecessor, +1: its successor), the edge sample repeated."""
    n = x.shape[dim]
    if step < 0:
        return torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, 0, n - 1)], dim)
    return torch.cat([x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)], dim)


def _interleave(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.stack([a, b], dim + 1).flatten(dim, dim + 1)


def upsample_fancy(x: torch.Tensor, fx: int, fy: int) -> torch.Tensor:
    """An (H, W) int32 chroma plane upsampled by (fx, fy) as libjpeg's
    jdsample.c does with fancy upsampling: the triangle filter for h2v1,
    h1v2 and h2v2 (h2v1 and h2v2 only on planes wider than 2 samples), box
    replication otherwise."""
    w = x.shape[1]
    if (fx, fy) == (2, 1) and w > 2:
        return _interleave((3 * x + _shifted(x, 1, -1) + 1) >> 2,
                           (3 * x + _shifted(x, 1, 1) + 2) >> 2, 1)
    if (fx, fy) == (1, 2):
        return _interleave((3 * x + _shifted(x, 0, -1) + 1) >> 2,
                           (3 * x + _shifted(x, 0, 1) + 2) >> 2, 0)
    if (fx, fy) == (2, 2) and w > 2:
        rows = []
        for s in (3 * x + _shifted(x, 0, -1), 3 * x + _shifted(x, 0, 1)):
            rows.append(_interleave((3 * s + _shifted(s, 1, -1) + 8) >> 4,
                                    (3 * s + _shifted(s, 1, 1) + 7) >> 4, 1))
        return _interleave(rows[0], rows[1], 0)
    return x.repeat_interleave(fy, 0).repeat_interleave(fx, 1)


def ycc_to_rgb(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor
               ) -> torch.Tensor:
    """libjpeg's fixed-point YCbCr -> RGB (jdcolor.c), int32 planes ->
    (H, W, 3) uint8."""
    cb, cr = cb - 128, cr - 128
    half = 1 << 15
    r = y + ((_fix16(1.40200) * cr + half) >> 16)
    g = y + ((-_fix16(0.34414) * cb + half - _fix16(0.71414) * cr) >> 16)
    b = y + ((_fix16(1.77200) * cb + half) >> 16)
    return torch.stack([r, g, b], -1).clamp_(0, 255).to(torch.uint8)


def orient(img: torch.Tensor, orientation: int) -> torch.Tensor:
    """An (H, W, C) image turned by its EXIF orientation (1-8) as OpenCV's
    imread turns it."""
    if orientation in (5, 6, 7, 8):
        img = img.transpose(0, 1)
    flips = {2: [1], 3: [0, 1], 4: [0], 6: [1], 7: [0, 1], 8: [0]}.get(
        orientation)
    return img.flip(flips) if flips else img


def jpeg_pixels(jf: JpegFile, device=None) -> torch.Tensor:
    """The device half of decoding: ``jf``'s blocks -> (H, W, 3) uint8 RGB
    on ``device`` (the card unless ``"cpu"``): dequantise, IDCT, fancy
    upsampling, colour conversion, orientation."""
    dev = resolve_device(device)
    planes = []
    for c in jf.components:
        bw, bh = jf.blocks_in(c)
        sw, sh = jf.samples_in(c)
        blocks = torch.from_numpy(np.ascontiguousarray(
            c.coefs[:bh, :bw])).to(dev).to(torch.int32)
        q = torch.from_numpy(jf.qtables[c.tq]).to(dev)
        px = idct_islow((blocks.view(-1, 64) * q).view(-1, 8, 8))
        plane = px.view(bh, bw, 8, 8).permute(0, 2, 1, 3).reshape(
            bh * 8, bw * 8)[:sh, :sw]
        plane = upsample_fancy(plane, jf.max_h // c.h, jf.max_v // c.v)
        planes.append(plane[:jf.height, :jf.width])
    if len(planes) == 1:
        rgb = planes[0].to(torch.uint8)[..., None].expand(-1, -1, 3)
    else:
        rgb = ycc_to_rgb(*planes)
    return orient(rgb, jf.orientation).contiguous()


def decode_jpeg(data: bytes, device=None, name: str = "<bytes>"
                ) -> torch.Tensor:
    """JPEG bytes -> (H, W, 3) uint8 RGB on ``device``."""
    return jpeg_pixels(parse_jpeg(data, name), device)


# ---------------------------------------------------------------------------
# JPEG: encoding (device transforms, host entropy coding)
# ---------------------------------------------------------------------------
def quality_tables(quality: int) -> Tuple[np.ndarray, np.ndarray]:
    """The IJG tables scaled to ``quality`` as jpeg_set_quality(quality,
    force_baseline=TRUE) scales them (natural order, int32)."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return tuple(np.clip((t * scale + 50) // 100, 1, 255).astype(np.int32)
                 for t in (STD_LUMA_QT, STD_CHROMA_QT))


def rgb_to_ycc(rgb: torch.Tensor) -> List[torch.Tensor]:
    """(H, W, 3) int32 RGB -> the Y, Cb, Cr int32 planes by libjpeg's
    rgb_ycc_convert (jccolor.c)."""
    r, g, b = rgb.unbind(-1)
    half, center = 1 << 15, 128 << 16
    y = (_fix16(0.29900) * r + _fix16(0.58700) * g
         + _fix16(0.11400) * b + half) >> 16
    cb = (-_fix16(0.16874) * r - _fix16(0.33126) * g
          + _fix16(0.50000) * b + center + half - 1) >> 16
    cr = (_fix16(0.50000) * r - _fix16(0.41869) * g
          - _fix16(0.08131) * b + center + half - 1) >> 16
    return [y, cb, cr]


def _pad_edge(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """``x`` grown to (rows, cols) by repeating its last row and column."""
    h, w = x.shape
    if rows > h:
        x = torch.cat([x, x[-1:].expand(rows - h, -1)], 0)
    if cols > w:
        x = torch.cat([x, x[:, -1:].expand(-1, cols - w)], 1)
    return x


def downsample(x: torch.Tensor, fx: int, fy: int) -> torch.Tensor:
    """libjpeg's h2v2 and h2v1 downsampling (jcsample.c: the sums rounded
    with the alternating biases 1, 2 and 0, 1), or the identity."""
    if (fx, fy) == (1, 1):
        return x
    bias = (torch.arange(x.shape[1] // fx, device=x.device) % 2)
    if (fx, fy) == (2, 2):
        s = x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2]
        return (s + 1 + bias) >> 2
    if (fx, fy) == (2, 1):
        return (x[:, 0::2] + x[:, 1::2] + bias) >> 1
    raise ValueError(f"downsampling by {fx}x{fy} is not supported")


def fdct_islow(samples: torch.Tensor) -> torch.Tensor:
    """(N, 8, 8) int32 level-shifted samples -> (N, 8, 8) int32
    coefficients (scaled by 8) by libjpeg's jpeg_fdct_islow (jfdctint.c)."""
    def one(d: List[torch.Tensor], even, shift: int) -> List[torch.Tensor]:
        t0, t7 = d[0] + d[7], d[0] - d[7]
        t1, t6 = d[1] + d[6], d[1] - d[6]
        t2, t5 = d[2] + d[5], d[2] - d[5]
        t3, t4 = d[3] + d[4], d[3] - d[4]
        t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
        out = [None] * 8
        out[0], out[4] = even(t10 + t11), even(t10 - t11)
        z1 = (t12 + t13) * F_0_541
        out[2] = _descale(z1 + t13 * F_0_765, shift)
        out[6] = _descale(z1 + t12 * -F_1_847, shift)
        z1, z2, z3, z4 = t4 + t7, t5 + t6, t4 + t6, t5 + t7
        z5 = (z3 + z4) * F_1_175
        t4, t5, t6, t7 = (t4 * F_0_298, t5 * F_2_053, t6 * F_3_072,
                          t7 * F_1_501)
        z1, z2 = z1 * -F_0_899, z2 * -F_2_562
        z3, z4 = z3 * -F_1_961 + z5, z4 * -F_0_390 + z5
        out[7] = _descale(t4 + z1 + z3, shift)
        out[5] = _descale(t5 + z2 + z4, shift)
        out[3] = _descale(t6 + z2 + z3, shift)
        out[1] = _descale(t7 + z1 + z4, shift)
        return out
    rows = torch.stack(one(list(samples.unbind(2)),
                           lambda v: v << PASS1_BITS,
                           CONST_BITS - PASS1_BITS), 2)
    return torch.stack(one(list(rows.unbind(1)),
                           lambda v: _descale(v, PASS1_BITS),
                           CONST_BITS + PASS1_BITS), 1)


def _reciprocals(q: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """libjpeg-turbo's compute_reciprocal (jcdctmgr.c) for the divisors
    8·q: the reciprocal, the rounding correction and the shift that make
    quantisation a multiply."""
    recip, corr, shift = [], [], []
    for d in (8 * q.astype(np.int64)).tolist():
        b = d.bit_length() - 1
        r = 16 + b
        fq, fr = divmod(1 << r, d)
        c = d // 2
        if fr == 0:
            fq >>= 1
            r -= 1
        elif fr <= d // 2:
            c += 1
        else:
            fq += 1
        recip.append(fq)
        corr.append(c)
        shift.append(r)
    return (np.array(recip, np.int64), np.array(corr, np.int64),
            np.array(shift, np.int64))


def quantize(coefs: torch.Tensor, q: np.ndarray) -> torch.Tensor:
    """(N, 64) int32 DCT output -> int16 quantised coefficients, by
    libjpeg-turbo's reciprocal multiply (jcdctmgr.c quantize)."""
    recip, corr, shift = (torch.from_numpy(a).to(coefs.device)
                          for a in _reciprocals(q))
    t = coefs.to(torch.int64)
    mag = ((t.abs() + corr) * recip) >> shift
    return torch.where(t < 0, -mag, mag).to(torch.int16)


def jpeg_forward(image: Union[np.ndarray, torch.Tensor], quality: int = 95,
                 subsampling: str = "4:2:0", device=None) -> JpegFile:
    """The device half of encoding: (H, W, 3) uint8 RGB (or (H, W) gray)
    -> a :class:`JpegFile` of quantised blocks, as libjpeg (cv2.imwrite)
    makes them: colour conversion, edge replication, downsampling, ISLOW
    forward DCT, quantisation, and libjpeg's dummy blocks (DC of their
    neighbour, no AC) where an MCU runs past the image."""
    if torch.is_tensor(image):
        dev = image.device if device is None else resolve_device(device)
        x = image.to(dev)
    else:
        dev = resolve_device(device)
        x = torch.from_numpy(np.ascontiguousarray(image)).to(dev)
    if x.dtype != torch.uint8 or x.dim() not in (2, 3) or (
            x.dim() == 3 and x.shape[2] != 3):
        raise ValueError(f"expected (H, W, 3) or (H, W) uint8, got "
                         f"{tuple(x.shape)} {x.dtype}")
    height, width = x.shape[:2]
    luma_q, chroma_q = quality_tables(quality)
    if x.dim() == 2:
        planes, factors, tq = [x.to(torch.int32)], [(1, 1)], [0]
    else:
        if subsampling not in SUBSAMPLING:
            raise ValueError(f"subsampling {subsampling!r}: one of "
                             f"{sorted(SUBSAMPLING)}")
        planes = rgb_to_ycc(x.to(torch.int32))
        factors, tq = SUBSAMPLING[subsampling], [0, 1, 1]
    comps = [JpegComponent(i + 1, h, v, t)
             for i, ((h, v), t) in enumerate(zip(factors, tq))]
    jf = JpegFile(width, height, comps, {0: luma_q, 1: chroma_q})
    mh, mv = jf.max_h, jf.max_v
    mx, my = jf.mcus if len(comps) > 1 else jf.blocks_in(comps[0])
    for c, plane in zip(comps, planes):
        bw, bh = jf.blocks_in(c)
        fx, fy = mh // c.h, mv // c.v
        plane = _pad_edge(plane, -(-height // mv) * mv, bw * 8 * fx)
        plane = downsample(plane, fx, fy)
        rows, cols = (my * c.v, mx * c.h) if len(comps) > 1 else (bh, bw)
        plane = _pad_edge(plane, rows * 8, cols * 8)
        blocks = plane.reshape(rows, 8, cols, 8).permute(0, 2, 1, 3) - 128
        coef = quantize(fdct_islow(blocks.reshape(-1, 8, 8)).view(-1, 64),
                        jf.qtables[c.tq]).view(rows, cols, 64)
        if cols > bw:                   # dummy blocks right of the image
            coef[:, bw:, 1:] = 0
            coef[:, bw:, 0] = coef[:, bw - 1:bw, 0]
        for r in range(bh, rows):       # and below it
            coef[r, :, 1:] = 0
            coef[r, :, 0] = coef[r - 1, c.h - 1::c.h, 0].repeat_interleave(
                c.h)
        c.coefs = coef.cpu().numpy()
    return jf


def jpeg_bytes(jf: JpegFile, encode_scan=host_encode_scan) -> bytes:
    """The host half of encoding: the markers libjpeg writes by default
    (JFIF APP0, DQT, SOF0, DHT, SOS) and the one scan, Huffman-coded with
    the Annex K tables by ``encode_scan``."""
    def segment(marker: int, body: bytes) -> bytes:
        return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body

    tables = HuffmanTables.standard()
    out = [b"\xff\xd8", segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01"
                                      b"\x00\x00")]
    for t in sorted({c.tq for c in jf.components}):
        out.append(segment(0xDB, bytes([t]) + bytes(
            jf.qtables[t][NATURAL].astype(np.uint8))))
    sof = struct.pack(">BHHB", 8, jf.height, jf.width, len(jf.components))
    for c in jf.components:
        sof += bytes([c.ident, (c.h << 4) | c.v, c.tq])
    out.append(segment(0xC0, sof))
    for t in sorted({c.tq for c in jf.components}):
        for cls in (0, 1):
            counts, symbols = STD_HUFFMAN[(cls, t)]
            out.append(segment(0xC4, bytes([(cls << 4) | t] + counts
                                           + symbols)))
    sos = bytes([len(jf.components)])
    for c in jf.components:
        sos += bytes([c.ident, (c.tq << 4) | c.tq])
    out.append(segment(0xDA, sos + b"\x00\x3f\x00"))
    if len(jf.components) > 1:
        mcus_x, mcus_y = jf.mcus
        scan = [ScanComponent(c.coefs, c.h, c.v, c.tq, c.tq)
                for c in jf.components]
    else:
        c = jf.components[0]
        mcus_x, mcus_y = jf.blocks_in(c)
        scan = [ScanComponent(c.coefs, 1, 1, 0, 0)]
    out.append(encode_scan(scan, tables, mcus_x, mcus_y))
    out.append(b"\xff\xd9")
    return b"".join(out)


def encode_jpeg(image: Union[np.ndarray, torch.Tensor], quality: int = 95,
                subsampling: str = "4:2:0", device=None) -> bytes:
    """(H, W, 3) uint8 RGB (or (H, W) gray) -> JPEG bytes, as
    cv2.imwrite(..., [IMWRITE_JPEG_QUALITY, quality]) writes them."""
    return jpeg_bytes(jpeg_forward(image, quality, subsampling, device))


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8),
               4: (8, 16), 6: (8, 16)}
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _png_chunks(data: bytes, name: str):
    if data[:8] != PNG_SIGNATURE:
        raise ImageError(f"{name}: not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ImageError(f"{name}: truncated PNG chunk {kind!r}")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body):
            raise ImageError(f"{name}: PNG chunk {kind!r} fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ImageError(f"{name}: truncated PNG (no IEND)")


def decode_png(data: bytes, name: str = "<bytes>",
               png_samples=host_png_samples) -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8 RGB on the host, as
    cv2.imread(IMREAD_COLOR) gives it (alpha dropped, 16 bits >> 8, gray
    below 8 bits scaled to 0..255, palette looked up)."""
    ihdr, palette, idat = None, None, []
    for kind, body in _png_chunks(data, name):
        if kind == b"IHDR":
            if len(body) != 13:
                raise ImageError(f"{name}: corrupt PNG IHDR")
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if ihdr is None or not idat:
        raise ImageError(f"{name}: PNG without IHDR or IDAT")
    w, h, depth, ctype, comp, filt, interlace = ihdr
    if depth not in _PNG_DEPTHS.get(ctype, ()) or comp or filt \
            or interlace > 1 or w == 0 or h == 0:
        raise ImageError(f"{name}: unsupported PNG header (colour type "
                         f"{ctype}, depth {depth}, interlace {interlace})")
    if w * h > MAX_PIXELS:
        raise ImageError(f"{name}: {w}x{h} is more than {MAX_PIXELS} pixels")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as exc:
        raise ImageError(f"{name}: corrupt PNG image data ({exc})")
    try:
        s = png_samples(raw, w, h, depth, _PNG_CHANNELS[ctype], interlace)
    except ImageError as exc:
        raise ImageError(f"{name}: {exc}")
    if ctype == 3:
        if palette is None:
            raise ImageError(f"{name}: palette PNG without PLTE")
        full = np.zeros((256, 3), np.uint8)
        full[:len(palette)] = palette[:256]
        return full[s[..., 0]]
    if depth == 16:
        s = s >> 8
    elif depth < 8:
        s = s * (255 // ((1 << depth) - 1))
    s = s.astype(np.uint8)
    if ctype in (0, 4):
        return np.repeat(s[..., :1], 3, axis=2)
    return np.ascontiguousarray(s[..., :3])


def encode_png(rgb: np.ndarray) -> bytes:
    """(H, W, 3) uint8 RGB -> PNG bytes (8-bit truecolour, filter 0,
    zlib), with the standard library only."""
    h, w = rgb.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          np.ascontiguousarray(rgb, np.uint8).reshape(h, -1)],
                         axis=1).tobytes()

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xffffffff))
    return (PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


# ---------------------------------------------------------------------------
# the API
# ---------------------------------------------------------------------------
def imdecode(data: bytes, device=None, name: str = "<bytes>"
             ) -> torch.Tensor:
    """JPEG or PNG bytes -> (H, W, 3) uint8 RGB on ``device`` (the card
    unless ``"cpu"``)."""
    if data[:8] == PNG_SIGNATURE:
        return torch.from_numpy(decode_png(data, name)).to(
            resolve_device(device))
    if data[:2] == b"\xff\xd8":
        return decode_jpeg(data, device, name)
    raise ImageError(f"{name}: neither JPEG nor PNG")


def imread(path: Union[str, Path], device=None) -> torch.Tensor:
    """``cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)`` for baseline
    JPEG and PNG files: (H, W, 3) uint8 RGB on ``device`` (the card unless
    ``"cpu"``).  Raises :class:`ImageError` naming the file on anything the
    codec does not read, and FileNotFoundError when there is no file."""
    return imdecode(Path(path).read_bytes(), device, str(path))


def imwrite(path: Union[str, Path], image: Union[np.ndarray, torch.Tensor],
            quality: int = 95, device=None) -> None:
    """Write (H, W, 3) uint8 RGB (or (H, W) gray, JPEG only) to ``path``:
    ``.jpg``/``.jpeg`` as cv2.imwrite writes them (4:2:0; the transforms
    on ``device``, a tensor's own by default, else the card), ``.png``
    unfiltered through zlib."""
    path = Path(path)
    suffix = path.suffix.lower()
    if suffix in (".jpg", ".jpeg"):
        data = encode_jpeg(image, quality, device=device)
    elif suffix == ".png":
        arr = image.cpu().numpy() if torch.is_tensor(image) else image
        data = encode_png(np.asarray(arr, np.uint8))
    else:
        raise ImageError(f"{path}: can write .jpg, .jpeg and .png only")
    path.write_bytes(data)


def image_size(path: Union[str, Path]) -> Tuple[int, int]:
    """(width, height) as stored in the file's header, as
    ``PIL.Image.open(path).size`` gives it (no EXIF turn)."""
    path = Path(path)
    with open(path, "rb") as f:
        head = f.read(33)
        if head[:8] == PNG_SIGNATURE:
            if head[12:16] != b"IHDR" or len(head) < 24:
                raise ImageError(f"{path}: PNG without IHDR")
            return struct.unpack(">II", head[16:24])
        if head[:2] != b"\xff\xd8":
            raise ImageError(f"{path}: neither JPEG nor PNG")
        f.seek(2)
        while True:
            b = f.read(1)
            while b == b"\xff":
                b = f.read(1)
            if not b:
                raise ImageError(f"{path}: no frame header")
            m = b[0]
            if 0xD0 <= m <= 0xD9 or m == 0x01:
                continue
            head = f.read(2)
            if len(head) != 2:
                raise ImageError(f"{path}: truncated JPEG header")
            seglen = struct.unpack(">H", head)[0]
            if 0xC0 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):
                sof = f.read(5)
                if len(sof) != 5:
                    raise ImageError(f"{path}: truncated frame header")
                h, w = struct.unpack(">xHH", sof)
                return w, h
            f.seek(seglen - 2, 1)
            if f.read(1) != b"\xff":
                raise ImageError(f"{path}: corrupt JPEG header")


def rows_at(frames: np.ndarray, rows, h: int, w: int,
            out: Optional[np.ndarray] = None) -> np.ndarray:
    """Host (B, T, H, W, 3) uint8, rows ``rows`` of axis 1 at (h, w), into
    ``out`` if given: gathered when the size already matches, else resized
    bilinearly on half-pixel centres without antialiasing, in uint8 on the
    CPU, as cv2.INTER_LINEAR (within 1)."""
    b, _, fh, fw, c = frames.shape
    shape = (b, len(rows), h, w, c)
    if out is None:
        out = np.empty(shape, np.uint8)
    if (fh, fw) == (h, w):
        # mode="clip": with mode="raise" numpy buffers ``out`` (a second
        # copy); the rows are in range
        return np.take(frames, rows, axis=1, out=out, mode="clip")
    x = torch.from_numpy(np.ascontiguousarray(frames[:, rows]))
    y = torch.nn.functional.interpolate(
        x.view((-1,) + x.shape[2:]).permute(0, 3, 1, 2), size=(h, w),
        mode="bilinear", align_corners=False, antialias=False)
    np.copyto(out, y.permute(0, 2, 3, 1).numpy().reshape(shape))
    return out


def resize(image: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(image, size)`` (``size`` = (width, height),
    INTER_LINEAR) within 1, on the host: :func:`rows_at` of one frame."""
    w, h = size
    return rows_at(image[None, None], [0], h, w)[0, 0]
