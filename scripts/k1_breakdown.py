#!/usr/bin/env python3
"""Where K1's time goes on the card: its bf16 device time at the shape the
full-width engine gives it for B = 2 clips (10 frames x 12 heads of 257
tokens, head dim 64, head-last views of three Linear outputs), built whole,
on its other route, with another grid, and with parts left out.

    python scripts/k1_breakdown.py

The method of ``scripts/k5_breakdown.py``, whose build it uses: its own
copies of ``attention`` built with nvcc (one process per row, all together)
into ``lameness_tpu_torch/_build/k1_breakdown/``, each from a copy of
``csrc/`` whose ``dino_attention.cuh`` it edits there; the package's
sources and library stay as they are.  Each row prints torch.profiler's
summed device time of the port's kernel over 20 calls:
  whole             the Hopper routine as the engine runs it: one block
                    per head (120 blocks), two consumer warpgroups taking
                    its five 64-row query tiles in turn; its output must
                    equal the package entry's, bit for bit;
  mma.sync route    -DLAMENESS_EMULATION: dino_entry takes attention.cuh's
                    online-softmax routine (K1 before the Hopper routine);
  one tile a block  the same routine with one consumer warpgroup and one
                    64-row tile a block (600 blocks, each reading the
                    head's whole K/V from L2);
  16-row boxes      K and V in 17 TMA boxes each, not 2;
                    (these two print whether their output equals the
                    whole's bit for bit: the same arithmetic per tile)
  no softmax        TMA, products and stores (P all zero);
  no products       TMA, softmax and stores;
  loads only        TMA and stores.
The stubbed copies compute wrong results; they are timings only.  The whole
kernel runs first and last, so that a drift of the card shows.  The card's
name and power limit come first.
"""
from __future__ import annotations

import ctypes
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from k5_breakdown import build, card, device_ms  # noqa: E402
from lameness_tpu_torch.ops import _cuda  # noqa: E402
from lameness_tpu_torch.ops import attention as at  # noqa: E402

OUT = _cuda.BUILD_DIR / "k1_breakdown"
# stubs in dino_attention.cuh: an anchor that is there once, and the line
# put after it (or, with True, the text put in its place)
_SMALL_BOXES = (("constexpr int kDinoBox = 136;",
                 "constexpr int kDinoBox = 16;", True),)
_ONE_TILE_A_BLOCK = (
    ("constexpr int kDinoWGs = 2;", "constexpr int kDinoWGs = 1;", True),
    ("constexpr int kDinoTiles = 5;", "constexpr int kDinoTiles = 1;", True))
_NO_SOFTMAX = (("float (&l)[2]) {",                           # dino_softmax
                "for (int c = 0; c < kDinoKeys / 16; ++c) "
                "p[c][0] = p[c][1] = p[c][2] = p[c][3] = 0u; "
                "l[0] = l[1] = 1.f; return;"),)
_NO_PRODUCTS = (("uint32_t k_s) {", "return;"),                    # dino_qk
                ("uint32_t v_s) {", "return;"))                    # dino_pv
# label, extra nvcc flags, stubs
ROWS = (("whole", (), ()),
        ("mma.sync route", ("-DLAMENESS_EMULATION",), ()),
        ("one tile a block", (), _ONE_TILE_A_BLOCK),
        ("16-row boxes", (), _SMALL_BOXES),
        ("no softmax", (), _NO_SOFTMAX),
        ("no products", (), _NO_PRODUCTS),
        ("loads only", (), _NO_SOFTMAX + _NO_PRODUCTS))


def main() -> int:
    card()
    source = at.KERNEL.source
    libs = [row[source] for row in build((source,), "dino_attention.cuh",
                                         ROWS, OUT)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(10, 257, 12, 64, generator=gen, device="cuda")
               .to(torch.bfloat16).transpose(1, 2) for _ in range(3))
    stream = torch.cuda.current_stream().cuda_stream

    def runner(lib):
        fn = getattr(lib, at.KERNEL.symbol)
        fn.argtypes, fn.restype = at.KERNEL.argtypes, ctypes.c_int
        out = torch.empty(10, 257, 12, 64, dtype=q.dtype,
                          device=q.device).transpose(1, 2)
        args = at.attention_args(q, k, v, out, 64 ** -0.5)

        def call():
            err = fn(*args, stream)
            if err:
                raise RuntimeError(f"{at.KERNEL.symbol}: cudaError_t {err}")
            return out
        return call

    whole = runner(libs[0])()
    if not torch.equal(whole, at.flash_attention(q, k, v)):
        raise SystemExit("the whole build differs from the package's kernel")
    for i in (2, 3):     # the same arithmetic per tile
        out = runner(libs[i])()
        torch.cuda.synchronize()
        print(f"{ROWS[i][0]} equals the whole bit for bit: "
              f"{torch.equal(out, whole)}", flush=True)
    for label, lib in zip([r[0] for r in ROWS] + ["whole"],
                          libs + [libs[0]]):
        print(f"K1 {label:16s} {device_ms(runner(lib), 20):.4f} ms",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
