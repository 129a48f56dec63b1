"""The port's MPEG-4 Part 2 (mp4v) codec, Simple Profile, without OpenCV or
FFmpeg.

The JAX package writes its clips with ``cv2.VideoWriter(mp4v)`` and reads
them through cv2's bundled FFmpeg; the card's machine has neither.  This
module decodes what that writer writes (I-VOPs and P-VOPs: half-pel motion
with one or four vectors, unrestricted vectors, intra DC/AC prediction,
resync markers) to the planes FFmpeg's decoder gives, and encodes
intra-only streams (every VOP an I-VOP, at a fixed quantiser).

The work is split in two, as in ``video/image.py``.  The bit-serial half
(headers, variable-length codes, and the DC, AC and motion-vector
predictions, which depend on the macroblocks decoded before) runs on the
host in ``csrc/host/mpeg4_codec.cpp`` (``ops/_host.py``).  The transforms
run as int32 tensor ops on the frames' device, the card by default:

- **decoding**: H.263 inverse quantisation, FFmpeg's C ``simple_idct``
  (``libavcodec/simple_idct_template.c``, 8-bit, its int16 stores
  included), and motion compensation (half-pel bilinear with the VOP's
  rounding type, reads clamped to the reference's edge, chroma vectors
  rounded as the standard rounds them).  A run of I-VOPs reconstructs
  ``batch`` frames at once; a P-VOP needs the frame before it, so a chain
  of P-VOPs reconstructs a frame at a time, all its macroblocks at once.
- **encoding**: libjpeg's integer forward DCT (``image.fdct_islow``),
  quantisation at a fixed QP to the nearest reconstruction level, and the
  intra DC/AC prediction decided from the quantised values, which are all
  known, so it is parallel too.  The encoder's reconstruction is the
  decoder's, so what it returns is what any FFmpeg-based reader shows.

Integer arithmetic throughout: the card's bytes and planes equal the
CPU's.  Out of scope, each refused with a named :class:`Mpeg4Error`:
Advanced Simple Profile (B-VOPs, quarter-pel, global motion and sprites,
MPEG quantisation matrices, interlace), data partitioning, shapes other
than rectangular and the other optional VOL tools.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..ops import _host
from .image import fdct_islow

# FFmpeg's dc_scaler tables (ISO/IEC 14496-2 Table 7-1) by QP
Y_DC_SCALE = np.array([0, 8, 8, 8, 8, 10, 12, 14, 16, 17, 18, 19, 20, 21, 22,
                       23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 34, 36, 38,
                       40, 42, 44, 46], np.int32)
C_DC_SCALE = np.array([0, 8, 8, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13,
                       14, 14, 15, 15, 16, 16, 17, 17, 18, 18, 19, 20, 21,
                       22, 23, 24, 25], np.int32)
# scan position -> natural index
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63], np.int64)
ALT_HORIZONTAL = np.array([
    0, 1, 2, 3, 8, 9, 16, 17, 10, 11, 4, 5, 6, 7, 15, 14,
    13, 12, 19, 18, 24, 25, 32, 33, 26, 27, 20, 21, 22, 23, 28, 29,
    30, 31, 34, 35, 40, 41, 48, 49, 42, 43, 36, 37, 38, 39, 44, 45,
    46, 47, 50, 51, 56, 57, 58, 59, 52, 53, 54, 55, 60, 61, 62, 63], np.int64)
ALT_VERTICAL = np.array([
    0, 8, 16, 24, 1, 9, 2, 10, 17, 25, 32, 40, 48, 56, 57, 49,
    41, 33, 26, 18, 3, 11, 4, 12, 19, 27, 34, 42, 50, 58, 35, 43,
    51, 59, 20, 28, 5, 13, 6, 14, 21, 29, 36, 44, 52, 60, 37, 45,
    53, 61, 22, 30, 7, 15, 23, 31, 38, 46, 54, 62, 39, 47, 55, 63], np.int64)
# the chroma rounding of a four-vector MB's summed vectors (FFmpeg's
# h263_chroma_roundtab; ISO/IEC 14496-2 Table 7-9)
CHROMA_ROUND = np.array([0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2],
                        np.int32)
# FFmpeg's simple_idct weights: cos(i pi / 16) sqrt(2) 2^14, rounded
W1, W2, W3, W4, W5, W6, W7 = 22725, 21407, 19266, 16383, 12873, 8867, 4520
ROW_SHIFT, COL_SHIFT = 11, 20

MB_INTRA, MB_INTER, MB_INTER4V, MB_SKIP = 0, 1, 2, 3
# the fixed quantiser of the port's writer: its luma PSNR on the test clips
# is at or above cv2's mp4v writer's, with a margin (tests/test_torch_mp4.py
# qp_table prints both at QP 2-5)
QP = 3

_ERRORS = {
    -1: "the stream ends early (truncated)",
    -2: "a bit pattern matches no code (corrupt data)",
    -3: "a marker bit is missing",
    -4: "a VOP comes before any video object layer header",
    -5: "a sample holds no VOP",
    -6: "a block's coefficients run past its 64th",
    -7: "a video packet header does not follow on",
    -8: "the picture does not fit the decoder's buffers",
    -9: "the output buffer is too small",
    -10: "a header field is out of range",
    -11: "an intra DC of more than 9 bits, or a negative one",
    -20: "video_object_layer_shape other than rectangular",
    -21: "interlaced video",
    -22: "sprites or global motion compensation (Advanced Simple Profile)",
    -23: "a bit depth other than 8 (not_8_bit)",
    -24: "MPEG quantisation matrices (Advanced Simple Profile)",
    -25: "quarter-pel motion (Advanced Simple Profile)",
    -26: "complexity estimation headers",
    -27: "data partitioning",
    -28: "newpred",
    -29: "reduced resolution VOPs",
    -30: "scalability",
    -31: "B-VOPs (Advanced Simple Profile)",
    -32: "S-VOPs (sprites, Advanced Simple Profile)",
    -33: "a chroma format other than 4:2:0",
    -34: "two VOPs in one sample (a packed B-frame bitstream)",
}


class Mpeg4Error(ValueError):
    """A stream the codec cannot read or write; the message says what the
    stream uses or where it is broken."""


def _lib() -> ctypes.CDLL:
    lib = _host.library("mpeg4_codec")
    if not getattr(lib, "_typed", False):
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
        lib.lt_m4v_read_config.argtypes = [p, i64, p]
        lib.lt_m4v_read_config.restype = ctypes.c_int
        lib.lt_m4v_decode_vop.argtypes = [p, p, i64, i32, p, p, p, p, p, p]
        lib.lt_m4v_decode_vop.restype = ctypes.c_int
        lib.lt_m4v_write_config.argtypes = [i32, i32, i32, p, i64]
        lib.lt_m4v_write_config.restype = ctypes.c_int64
        lib.lt_m4v_encode_ivop.argtypes = [p, p, p, p, i64]
        lib.lt_m4v_encode_ivop.restype = ctypes.c_int64
        lib._typed = True
    return lib


def _check(rc: int, what: str) -> int:
    if rc < 0:
        raise Mpeg4Error(f"{what}: {_ERRORS.get(int(rc), f'error {rc}')}")
    return rc


# ---------------------------------------------------------------------------
# the bitstream half (host)
# ---------------------------------------------------------------------------
@dataclass
class Layer:
    """A video object layer: the picture size, and the host library's
    state of the layer's headers."""
    width: int
    height: int
    state: np.ndarray        # the host library's int32[16] VOL state

    @property
    def mbw(self) -> int:
        return (self.width + 15) // 16

    @property
    def mbh(self) -> int:
        return (self.height + 15) // 16


def read_config(config: bytes, what: str = "mp4v") -> Layer:
    """The VOL header in a decoder configuration (an esds's
    DecoderSpecificInfo, or a stream's first sample)."""
    state = np.zeros(16, np.int32)
    buf = np.frombuffer(config, np.uint8)
    _check(_lib().lt_m4v_read_config(buf.ctypes.data, buf.size,
                                     state.ctypes.data), what)
    return Layer(int(state[1]), int(state[2]), state)


@dataclass
class Vop:
    """One decoded VOP's macroblock data, as the device half takes it."""
    type: int                # 0 I, 1 P
    coded: bool
    rounding: int
    levels: np.ndarray       # (nmb, 6, 64) int16, natural order
    mbtype: np.ndarray       # (nmb,) int8
    mbqp: np.ndarray         # (nmb,) int8
    mv: np.ndarray           # (nmb, 4, 2) int16, half-pel


def decode_vop(layer: Layer, sample: bytes, what: str = "mp4v") -> Vop:
    """The bitstream half of decoding one sample (any headers it carries
    read into a copy of the layer's state: calls may run in parallel)."""
    nmb = layer.mbw * layer.mbh
    state = layer.state.copy()
    vop = np.zeros(12, np.int32)
    levels = np.empty((nmb, 6, 64), np.int16)
    mbtype = np.empty(nmb, np.int8)
    mbqp = np.empty(nmb, np.int8)
    mv = np.empty((nmb, 4, 2), np.int16)
    work = np.empty(nmb * 6 * 17 + nmb, np.int32)
    buf = np.frombuffer(sample, np.uint8)
    _check(_lib().lt_m4v_decode_vop(
        state.ctypes.data, buf.ctypes.data, buf.size, nmb,
        vop.ctypes.data, levels.ctypes.data, mbtype.ctypes.data,
        mbqp.ctypes.data, mv.ctypes.data, work.ctypes.data), what)
    if (int(state[1]), int(state[2])) != (layer.width, layer.height):
        raise Mpeg4Error(f"{what}: a VOL header changes the picture size")
    return Vop(int(vop[0]), bool(vop[1]), int(vop[2]), levels, mbtype, mbqp,
               mv)


def write_config(width: int, height: int, time_res: int) -> bytes:
    """The decoder configuration of an intra-only stream: VOS (Simple
    Profile), visual object, video object and VOL headers."""
    out = np.empty(64, np.uint8)
    n = _check(_lib().lt_m4v_write_config(width, height, time_res,
                                          out.ctypes.data, out.size),
               "mp4v writer")
    return out[:n].tobytes()


def encode_ivop(width: int, height: int, time_res: int, seconds: int,
                tinc: int, coefs: np.ndarray, acpred: np.ndarray) -> bytes:
    """The bitstream half of encoding one I-VOP at QP (a GOV header before
    it, its time code ``seconds``; ``tinc`` the VOP's time increment):
    ``coefs`` (nmb, 6, 64) int16 in transmission order, ``acpred`` (nmb,)
    uint8."""
    coefs = np.ascontiguousarray(coefs, np.int16)
    acpred = np.ascontiguousarray(acpred, np.uint8)
    nmb = ((width + 15) // 16) * ((height + 15) // 16)
    if coefs.shape != (nmb, 6, 64) or acpred.shape != (nmb,):
        raise ValueError(f"coefs {coefs.shape} and acpred {acpred.shape} "
                         f"do not hold {nmb} macroblocks")
    params = np.array([width, height, time_res, QP, seconds, tinc, 0, 0],
                      np.int32)
    # the escape codes bound a block at 64 x 30 bits and an MB's header
    out = np.empty(nmb * (6 * 64 * 30 // 8 + 16) + 64, np.uint8)
    n = _check(_lib().lt_m4v_encode_ivop(
        params.ctypes.data, coefs.ctypes.data, acpred.ctypes.data,
        out.ctypes.data, out.size), "mp4v writer")
    return out[:n].tobytes()


# ---------------------------------------------------------------------------
# the transforms (device)
# ---------------------------------------------------------------------------
def _table(values: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(values).to(device)


def _wrap16(x: torch.Tensor) -> torch.Tensor:
    """int32 -> the int16 a C store would keep."""
    return ((x + 32768) & 0xFFFF) - 32768


def dequantize(levels: torch.Tensor, qp: torch.Tensor,
               intra: torch.Tensor) -> torch.Tensor:
    """(N, 6, 64) int32 levels, (N,) QPs and intra flags -> coefficients
    by the H.263 inverse quantisation: |F| = 2 QP |L| + ((QP - 1) | 1), an
    intra block's DC times its dc_scaler, every coefficient saturated to
    [-2048, 2047] (ISO/IEC 14496-2 7.4.3).  Conforming encoders stay in
    that range, where this is FFmpeg's result; FFmpeg saturates only inter
    blocks, and past the range its x86 IDCT gives other pixels than its C
    one (tests/test_torch_mp4.py measures how many)."""
    dev = levels.device
    q = qp.to(torch.int32)[:, None, None]
    qadd = (q - 1) | 1
    mag = levels.abs() * (2 * q) + qadd
    f = torch.where(levels > 0, mag, torch.where(levels < 0, -mag, 0))
    scale = torch.stack([_table(Y_DC_SCALE, dev)[qp.long()]] * 4
                        + [_table(C_DC_SCALE, dev)[qp.long()]] * 2, 1)
    dc = levels[:, :, 0] * scale
    f = torch.where(intra[:, None, None],
                    torch.cat([dc[:, :, None], f[:, :, 1:]], 2), f)
    return f.clamp(-2048, 2047)


def simple_idct(blocks: torch.Tensor) -> torch.Tensor:
    """(N, 8, 8) int32 int16-valued coefficients -> (N, 8, 8) int32
    residuals: FFmpeg's C simple_idct, 8-bit (idctRowCondDC with its
    DC-only rows, idctSparseColPut before the clip), int16 row stores
    included."""
    r = blocks.unbind(2)
    a0 = W4 * r[0] + (1 << (ROW_SHIFT - 1))
    a1, a2, a3 = a0 + W6 * r[2], a0 - W6 * r[2], a0 - W2 * r[2]
    a0 = a0 + W2 * r[2]
    b0 = W1 * r[1] + W3 * r[3]
    b1 = W3 * r[1] - W7 * r[3]
    b2 = W5 * r[1] - W1 * r[3]
    b3 = W7 * r[1] - W5 * r[3]
    a0 = a0 + W4 * r[4] + W6 * r[6]
    a1 = a1 - W4 * r[4] - W2 * r[6]
    a2 = a2 - W4 * r[4] + W2 * r[6]
    a3 = a3 + W4 * r[4] - W6 * r[6]
    b0 = b0 + W5 * r[5] + W7 * r[7]
    b1 = b1 - W1 * r[5] - W5 * r[7]
    b2 = b2 + W7 * r[5] + W3 * r[7]
    b3 = b3 + W3 * r[5] - W1 * r[7]
    rows = torch.stack([a0 + b0, a1 + b1, a2 + b2, a3 + b3,
                        a3 - b3, a2 - b2, a1 - b1, a0 - b0], 2) >> ROW_SHIFT
    dc_only = (blocks[:, :, 1:] == 0).all(2, keepdim=True)
    rows = _wrap16(torch.where(dc_only, (r[0] * 8)[:, :, None], rows))
    c = rows.unbind(1)
    a0 = W4 * (c[0] + ((1 << (COL_SHIFT - 1)) // W4))
    a1, a2, a3 = a0 + W6 * c[2], a0 - W6 * c[2], a0 - W2 * c[2]
    a0 = a0 + W2 * c[2]
    b0 = W1 * c[1] + W3 * c[3]
    b1 = W3 * c[1] - W7 * c[3]
    b2 = W5 * c[1] - W1 * c[3]
    b3 = W7 * c[1] - W5 * c[3]
    a0 = a0 + W4 * c[4] + W6 * c[6]
    a1 = a1 - W4 * c[4] - W2 * c[6]
    a2 = a2 - W4 * c[4] + W2 * c[6]
    a3 = a3 + W4 * c[4] - W6 * c[6]
    b0 = b0 + W5 * c[5] + W7 * c[7]
    b1 = b1 - W1 * c[5] - W5 * c[7]
    b2 = b2 + W7 * c[5] + W3 * c[7]
    b3 = b3 + W3 * c[5] - W1 * c[7]
    return torch.stack([a0 + b0, a1 + b1, a2 + b2, a3 + b3,
                        a3 - b3, a2 - b2, a1 - b1, a0 - b0], 1) >> COL_SHIFT


def _blocks_to_planes(px: torch.Tensor, mbh: int, mbw: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(F, nmb, 6, 8, 8) -> Y (F, 16 mbh, 16 mbw), U and V (F, 8 mbh,
    8 mbw)."""
    f = px.shape[0]
    y = px[:, :, :4].reshape(f, mbh, mbw, 2, 2, 8, 8).permute(
        0, 1, 3, 5, 2, 4, 6).reshape(f, 16 * mbh, 16 * mbw)
    u, v = (px[:, :, k].reshape(f, mbh, mbw, 8, 8).permute(
        0, 1, 3, 2, 4).reshape(f, 8 * mbh, 8 * mbw) for k in (4, 5))
    return y, u, v


def _planes_to_blocks(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor
                      ) -> torch.Tensor:
    """The inverse of ``_blocks_to_planes``."""
    f, h, w = y.shape
    mbh, mbw = h // 16, w // 16
    yb = y.reshape(f, mbh, 2, 8, mbw, 2, 8).permute(
        0, 1, 4, 2, 5, 3, 6).reshape(f, mbh * mbw, 4, 8, 8)
    cb = [c.reshape(f, mbh, 8, mbw, 8).permute(0, 1, 3, 2, 4).reshape(
        f, mbh * mbw, 1, 8, 8) for c in (u, v)]
    return torch.cat([yb] + cb, 2)


def _residuals(levels: torch.Tensor, qp: torch.Tensor, intra: torch.Tensor
               ) -> torch.Tensor:
    """(M, 6, 64) levels -> (M, 6, 8, 8) int32 IDCT outputs."""
    m = levels.shape[0]
    coefs = dequantize(levels.to(torch.int32), qp, intra)
    return simple_idct(coefs.reshape(m * 6, 8, 8)).reshape(m, 6, 8, 8)


def _predict(ref: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor,
             mx: torch.Tensor, my: torch.Tensor, rounding: int,
             clip: Optional[Tuple[int, int, int, torch.Tensor]] = None,
             narrow: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Half-pel prediction of 8x8 blocks at (x0, y0) moved by (mx, my)
    half-pels from one plane, every read clamped to its edge:
    (a + b + 1 - r) >> 1 and (a + b + c + d + 2 - r) >> 2.  ``clip``
    (lo, width, height, which): the blocks marked in ``which`` have their
    source corner clipped to [lo, width] x [lo, height] first, dropping the
    half-pel step at the upper bound, as FFmpeg's hpel_motion and
    chroma_4mv_motion clip the blocks of four-vector MBs.  ``narrow``
    marks the blocks FFmpeg predicts with its 8-wide functions, whose x86
    no-rounding half-pel averages are pavgb(a - 1, b) with a saturating
    decrement: off by one where the decremented pixel is 0 (the vertical
    one decrements the lower pixel on even rows, the upper on odd)."""
    h, w = ref.shape
    ix, iy = x0 + (mx >> 1), y0 + (my >> 1)
    fx, fy = (mx & 1).bool(), (my & 1).bool()
    if clip is not None:
        lo, cw, ch, which = clip
        cx, cy = ix.clamp(lo, cw), iy.clamp(lo, ch)
        fx = fx & ~(which & (cx == cw))
        fy = fy & ~(which & (cy == ch))
        ix, iy = torch.where(which, cx, ix), torch.where(which, cy, iy)
    k = torch.arange(9, device=ref.device)
    rows = (iy[:, None] + k).clamp_(0, h - 1)
    cols = (ix[:, None] + k).clamp_(0, w - 1)
    p = ref[rows[:, :, None], cols[:, None, :]].to(torch.int32)
    fx, fy = fx[:, None, None], fy[:, None, None]
    a, b = p[:, :8, :8], p[:, :8, 1:]
    c, d = p[:, 1:, :8], p[:, 1:, 1:]
    hx = (a + b + 1 - rounding) >> 1
    hy = (a + c + 1 - rounding) >> 1
    if rounding and narrow is not None:
        even = (k[:8] % 2 == 0)[None, :, None]
        n = narrow[:, None, None]
        hx = torch.where(n & (a == 0), (b + 1) >> 1, hx)
        lower = torch.where(even, c, a) == 0
        hy = torch.where(n & lower, (a + c + 1) >> 1, hy)
    return torch.where(fx & fy, (a + b + c + d + 2 - rounding) >> 2,
                       torch.where(fx, hx, torch.where(fy, hy, a)))


def _motion(ref: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
            mbtype: torch.Tensor, mv: torch.Tensor, layer: Layer,
            rounding: int) -> torch.Tensor:
    """The (nmb, 6, 8, 8) prediction of every MB from the reference planes
    (decoded at whole MBs; reads past them clamped): luma per 8x8 block,
    chroma with the vector FFmpeg derives (one vector: (v >> 1) | (v & 1);
    four: their sum through CHROMA_ROUND), a four-vector MB's blocks
    clipped to the picture as FFmpeg clips them.  A one-vector MB's luma
    is FFmpeg's 16-wide prediction, every other block its 8-wide one."""
    dev = mv.device
    nmb = mv.shape[0]
    mb = torch.arange(nmb, device=dev)
    mbx, mby = mb % layer.mbw, mb // layer.mbw
    k = torch.arange(4, device=dev)
    x0 = (16 * mbx[:, None] + 8 * (k & 1)).reshape(-1)
    y0 = (16 * mby[:, None] + 8 * (k >> 1)).reshape(-1)
    m = mv.to(torch.int32)
    four = mbtype == MB_INTER4V
    four4 = four.repeat_interleave(4)
    luma = _predict(ref[0], x0, y0, m[:, :, 0].reshape(-1),
                    m[:, :, 1].reshape(-1), rounding,
                    (-16, layer.width, layer.height, four4),
                    four4).reshape(nmb, 4, 8, 8)
    total = m.sum(1)
    c4 = _table(CHROMA_ROUND, dev)[(total & 15).long()] + (total >> 3)
    one = m[:, 0]
    cm = torch.where(four[:, None], c4, (one >> 1) | (one & 1))
    bounds = (-8, layer.width >> 1, layer.height >> 1, four)
    every = torch.ones_like(four)
    chroma = [_predict(plane, 8 * mbx, 8 * mby, cm[:, 0], cm[:, 1],
                       rounding, bounds, every) for plane in ref[1:]]
    return torch.cat([luma] + [c[:, None] for c in chroma], 1)


class Mpeg4Decoder:
    """The transforms of decoding on ``device``: ``reconstruct(vops)``
    turns consecutive decoded VOPs (``decode_vop``) into (N, H*3//2, W)
    uint8 I420 frames, keeping the last frame as the next P-VOP's
    reference."""

    def __init__(self, layer: Layer, device=None, batch: int = 16):
        if layer.width % 2 or layer.height % 2:
            raise Mpeg4Error(f"a {layer.width}x{layer.height} picture: the "
                             f"port's frames are I420, with even sides")
        self.layer = layer
        self.device = resolve_device(device)
        self.batch = batch
        self.ref: Optional[Tuple[torch.Tensor, ...]] = None

    def reset(self) -> None:
        self.ref = None

    def _intra(self, vops: Sequence[Vop]) -> List[Tuple[torch.Tensor, ...]]:
        lay, dev = self.layer, self.device
        nmb = lay.mbw * lay.mbh
        levels = torch.from_numpy(np.stack([v.levels for v in vops])).to(dev)
        qp = torch.from_numpy(np.stack([v.mbqp for v in vops])).to(dev)
        f = len(vops)
        ones = torch.ones(f * nmb, dtype=torch.bool, device=dev)
        res = _residuals(levels.reshape(f * nmb, 6, 64),
                         qp.reshape(-1).to(torch.int32), ones)
        px = res.clamp_(0, 255).to(torch.uint8).reshape(f, nmb, 6, 8, 8)
        y, u, v = _blocks_to_planes(px, lay.mbh, lay.mbw)
        return [(y[i], u[i], v[i]) for i in range(f)]

    def _inter(self, vop: Vop) -> Tuple[torch.Tensor, ...]:
        if self.ref is None:
            raise Mpeg4Error("a P-VOP with no frame before it to predict "
                             "from (the stream starts mid-GOP)")
        lay, dev = self.layer, self.device
        mbtype = torch.from_numpy(vop.mbtype).to(dev)
        qp = torch.from_numpy(vop.mbqp).to(dev).to(torch.int32)
        levels = torch.from_numpy(vop.levels).to(dev)
        mv = torch.from_numpy(vop.mv).to(dev)
        intra = mbtype == MB_INTRA
        res = _residuals(levels, qp, intra)
        pred = _motion(self.ref, mbtype, mv, lay, vop.rounding)
        px = torch.where(intra[:, None, None, None], res, pred + res)
        px = px.clamp_(0, 255).to(torch.uint8)
        y, u, v = _blocks_to_planes(px[None], lay.mbh, lay.mbw)
        return y[0], u[0], v[0]

    def reconstruct(self, vops: Sequence[Vop]) -> torch.Tensor:
        frames: List[Tuple[torch.Tensor, ...]] = []
        i = 0
        while i < len(vops):
            v = vops[i]
            if not v.coded:                  # repeats the frame before
                if self.ref is None:
                    raise Mpeg4Error("a not-coded VOP with no frame before "
                                     "it")
                frames.append(self.ref)
                i += 1
            elif v.type == 0:
                j = i
                while (j < len(vops) and j - i < self.batch
                       and vops[j].type == 0 and vops[j].coded):
                    j += 1
                frames.extend(self._intra(vops[i:j]))
                self.ref = frames[-1]
                i = j
            else:
                frames.append(self._inter(v))
                self.ref = frames[-1]
                i += 1
        return self.to_i420(frames)

    def to_i420(self, planes: Sequence[Tuple[torch.Tensor, ...]]
                ) -> torch.Tensor:
        h, w = self.layer.height, self.layer.width
        out = torch.empty((len(planes), h * 3 // 2, w), dtype=torch.uint8,
                          device=self.device)
        flat = out.view(len(planes), -1)
        n, q = h * w, h * w // 4
        for i, (y, u, v) in enumerate(planes):
            flat[i, :n] = y[:h, :w].reshape(-1)
            flat[i, n:n + q] = u[:h // 2, :w // 2].reshape(-1)
            flat[i, n + q:] = v[:h // 2, :w // 2].reshape(-1)
        return out


# ---------------------------------------------------------------------------
# encoding (device transforms, host bit coding)
# ---------------------------------------------------------------------------
def _pad_planes(i420: torch.Tensor, mbh: int, mbw: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(F, H*3//2, W) uint8 -> its planes grown to whole MBs by repeating
    the last row and column, int32."""
    f, h15, w = i420.shape
    h = h15 * 2 // 3
    flat = i420.reshape(f, -1).to(torch.int32)
    n, q = h * w, h * w // 4
    planes = [flat[:, :n].reshape(f, h, w),
              flat[:, n:n + q].reshape(f, h // 2, w // 2),
              flat[:, n + q:].reshape(f, h // 2, w // 2)]
    out = []
    for p, s in zip(planes, (16, 8, 8)):
        ph, pw = mbh * s, mbw * s
        rows = torch.arange(ph, device=p.device).clamp_(max=p.shape[1] - 1)
        cols = torch.arange(pw, device=p.device).clamp_(max=p.shape[2] - 1)
        out.append(p[:, rows][:, :, cols])
    return out[0], out[1], out[2]


def _neighbour(x: torch.Tensor, dy: int, dx: int, fill: int
               ) -> torch.Tensor:
    """x (..., H, W, ...) shifted so that [i, j] holds x[i + dy, j + dx]
    (dy, dx in {-1, 0}), ``fill`` outside."""
    if dy:
        x = torch.cat([torch.full_like(x[:, :1], fill), x[:, :-1]], 1)
    if dx:
        x = torch.cat([torch.full_like(x[:, :, :1], fill), x[:, :, :-1]], 2)
    return x


def _block_grid(b: torch.Tensor, mbh: int, mbw: int) -> List[torch.Tensor]:
    """(F, nmb, 6, ...) -> [luma (F, 2 mbh, 2 mbw, ...), U (F, mbh, mbw,
    ...), V]."""
    f, rest = b.shape[0], tuple(b.shape[3:])
    y = b[:, :, :4].reshape((f, mbh, mbw, 2, 2) + rest).permute(
        (0, 1, 3, 2, 4) + tuple(range(5, 5 + len(rest)))).reshape(
        (f, 2 * mbh, 2 * mbw) + rest)
    return [y] + [b[:, :, k].reshape((f, mbh, mbw) + rest) for k in (4, 5)]


def _grid_to_blocks(grids: List[torch.Tensor], mbh: int, mbw: int
                    ) -> torch.Tensor:
    """The inverse of ``_block_grid``."""
    y = grids[0]
    f, rest = y.shape[0], tuple(y.shape[3:])
    yb = y.reshape((f, mbh, 2, mbw, 2) + rest).permute(
        (0, 1, 3, 2, 4) + tuple(range(5, 5 + len(rest)))).reshape(
        (f, mbh * mbw, 4) + rest)
    cb = [g.reshape((f, mbh * mbw, 1) + rest) for g in grids[1:]]
    return torch.cat([yb] + cb, 2)


@dataclass
class EncodedFrames:
    """The device half's output for F frames: transmission-order levels,
    ac_pred flags, and the reconstruction every FFmpeg-based reader
    gives."""
    coefs: torch.Tensor       # (F, nmb, 6, 64) int16
    acpred: torch.Tensor      # (F, nmb) uint8
    recon: torch.Tensor       # (F, H*3//2, W) uint8 I420


def encode_forward(i420: torch.Tensor) -> EncodedFrames:
    """The transforms of intra encoding on the frames' device: (F, H*3//2,
    W) uint8 I420 -> levels quantised at QP to the nearest reconstruction
    level, their DC and AC predictions, and the frames as the decoder
    rebuilds them."""
    qp = QP
    dev = i420.device
    f, h15, w = i420.shape
    h = h15 * 2 // 3
    mbh, mbw = (h + 15) // 16, (w + 15) // 16
    nmb = mbh * mbw
    planes = _pad_planes(i420, mbh, mbw)
    px = _planes_to_blocks(*planes)                      # (F, nmb, 6, 8, 8)
    out = fdct_islow(px.reshape(-1, 8, 8) - 128).reshape(f, nmb, 6, 64)
    dc_sum = out[..., 0] + 64 * 128                      # the block's sum
    scale = torch.tensor([int(Y_DC_SCALE[qp])] * 4 + [int(C_DC_SCALE[qp])]
                         * 2, dtype=torch.int32, device=dev)
    qdc = (dc_sum + 4 * scale) // (8 * scale)
    # AC: 8 x the coefficient; floor(|F| / 2QP), and 1 from 1.5 QP up
    mag = out.abs()
    lv = mag // (16 * qp)
    lv = torch.where((lv == 0) & (mag >= 12 * qp), 1, lv)
    levels = torch.where(out < 0, -lv, lv)
    levels[..., 0] = qdc
    # what the decoder rebuilds
    ones = torch.ones(f * nmb, dtype=torch.bool, device=dev)
    qps = torch.full((f * nmb,), qp, dtype=torch.int32, device=dev)
    res = _residuals(levels.reshape(f * nmb, 6, 64), qps, ones)
    rec = res.clamp_(0, 255).to(torch.uint8).reshape(f, nmb, 6, 8, 8)
    ry, ru, rv = _blocks_to_planes(rec, mbh, mbw)
    recon = torch.cat([ry[:, :h, :w].reshape(f, -1),
                       ru[:, :h // 2, :w // 2].reshape(f, -1),
                       rv[:, :h // 2, :w // 2].reshape(f, -1)],
                      1).reshape(f, h15, w)
    coefs, acpred = _predict_intra(levels, scale, mbh, mbw)
    return EncodedFrames(coefs.to(torch.int16), acpred, recon)


def _predict_intra(levels: torch.Tensor, scale: torch.Tensor, mbh: int,
                   mbw: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every block's DC and AC prediction at once (one packet, one QP: the
    neighbours' values are all known): the DC difference, the first row or
    column predicted where that lowers the MB's sum of magnitudes (FFmpeg's
    decide_ac_pred), and the levels put in their scan order."""
    dev = levels.device
    f, nmb = levels.shape[:2]
    nat = levels.reshape(f, nmb, 6, 8, 8)
    stored = (nat[..., 0, 0] * scale)
    stored = torch.where((stored & ~2047) != 0,
                         torch.where(stored < 0, 0, 2047), stored)
    col = nat[..., 1:, 0]                                # (F, nmb, 6, 7)
    row = nat[..., 0, 1:]
    g_dc = _block_grid(stored, mbh, mbw)
    g_col = _block_grid(col, mbh, mbw)
    g_row = _block_grid(row, mbh, mbw)
    dirs, p_col, p_row = [], [], []
    for dc, c, r in zip(g_dc, g_col, g_row):
        a = _neighbour(dc, 0, -1, 1024)
        b = _neighbour(dc, -1, -1, 1024)
        top = _neighbour(dc, -1, 0, 1024)
        d = (a - b).abs() < (b - top).abs()              # True: from above
        dirs.append(d)
        p_col.append(_neighbour(c, 0, -1, 0))
        p_row.append(_neighbour(r, -1, 0, 0))
    pred_dc = torch.where(_grid_to_blocks(dirs, mbh, mbw),
                          _grid_to_blocks([_neighbour(g, -1, 0, 1024)
                                           for g in g_dc], mbh, mbw),
                          _grid_to_blocks([_neighbour(g, 0, -1, 1024)
                                           for g in g_dc], mbh, mbw))
    pred_dc = (pred_dc + (scale >> 1)) // scale
    top = _grid_to_blocks(dirs, mbh, mbw)                # (F, nmb, 6)
    left_col = _grid_to_blocks(p_col, mbh, mbw)
    above_row = _grid_to_blocks(p_row, mbh, mbw)
    res_col = col - left_col
    res_row = row - above_row
    t = top[..., None]
    before = torch.where(t, row, col).abs().sum((2, 3))
    after = torch.where(t, res_row, res_col).abs().sum((2, 3))
    acpred = after < before                              # (F, nmb)
    use = acpred[:, :, None]
    pred = nat.clone()
    pred[..., 0, 0] = nat[..., 0, 0] - pred_dc
    pred[..., 1:, 0] = torch.where(use[..., None] & ~t, res_col, col)
    pred[..., 0, 1:] = torch.where(use[..., None] & t, res_row, row)
    scans = torch.stack([_table(ZIGZAG, dev), _table(ALT_VERTICAL, dev),
                         _table(ALT_HORIZONTAL, dev)])
    which = torch.where(use, torch.where(top, 2, 1), 0)  # (F, nmb, 6)
    order = scans[which]                                 # (F, nmb, 6, 64)
    coefs = torch.gather(pred.reshape(f, nmb, 6, 64), 3, order)
    return coefs, acpred.to(torch.uint8)
