#!/usr/bin/env python3
"""Where the window routine's time goes on the card: the bf16 device time of
K2 and K7 at the shapes the full-width engine gives them for B = 2 clips
(550 windows of 196 tokens, 14 x 14: 12 heads of 64 with SAM ViT-B, 16 of
80 with ViT-H), built whole and with parts of the routine left out.  K9 and
K8 run the same routine on the same operands through the same route choice
(window_entry), so K2's rows are K9's and K7's are K8's.

    python scripts/window_breakdown.py        # ViT-B, head dim 64
    python scripts/window_breakdown.py 80     # ViT-H, head dim 80

The method of ``scripts/k5_breakdown.py``, whose build it uses: its own
copies of ``sam_window_attention`` (K2) and ``sam_window_attention_v1`` (K7)
built with nvcc (one process per row and source, all together) into
``lameness_tpu_torch/_build/window_breakdown/``, each from a copy of
``csrc/`` whose ``window_attention.cuh`` it edits there; the package's
sources and libraries stay as they are.  Each row prints torch.profiler's
summed device time of the port's kernel over 20 calls:
  whole            the kernel as the engine runs it (the window routine);
                   its output must equal the package entry's, bit for bit;
  mma.sync route   window_takes() answers no: the entry takes the online
                   softmax routine of attention.cuh on the same inputs (the
                   per-score bias route);
  no softmax       loads, staging and products;
  no products      loads, staging and softmax (the mma.sync calls removed,
                   their ldmatrix kept);
  staging only     loads and staging, the ldmatrix and the output stores.
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
from lameness_tpu_torch.ops import sam_attention as sa  # noqa: E402

OUT = _cuda.BUILD_DIR / "window_breakdown"
KERNELS = {"K2": sa.WINDOW_KERNEL, "K7": sa.WINDOW_V1_KERNEL}
# a stub: an anchor that is in window_attention.cuh once, and the line put
# after it
_OLD_ROUTE = (("int dtype) {", "return false;"),)            # window_takes
_NO_SOFTMAX = (("float c2, float (&l)[2]) {",                 # window_softmax
                "l[0] = l[1] = 1.f; return;"),)
_NO_PRODUCTS = (("namespace lameness {",
                 "\n#define mma_bf16_16816(...) ((void)0)"),)
# label, extra nvcc flags, stubs
ROWS = (("whole", (), ()),
        ("mma.sync route", (), _OLD_ROUTE),
        ("no softmax", (), _NO_SOFTMAX),
        ("no products", (), _NO_PRODUCTS),
        ("staging only", (), _NO_SOFTMAX + _NO_PRODUCTS))


def main() -> int:
    hd = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    heads = {64: 12, 80: 16}[hd]
    card()
    print(f"head dim {hd}, {heads} heads", flush=True)
    libs = build(tuple(k.source for k in KERNELS.values()),
                 "window_attention.cuh", ROWS, OUT)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * std
                ).to(torch.bfloat16)
    q4, k4, v4 = rnd(550, 196, 3, heads, hd).unbind(2)
    rh4, rw4 = sa.project_rel_tables_hl(q4, rnd(27, hd, std=0.1),
                                        rnd(27, hd, std=0.1), 14)
    q, k, v = (t.transpose(1, 2) for t in (q4, k4, v4))
    rh, rw = (t.reshape(550, heads, 196, 14) for t in sa.project_rel_tables(
        q.reshape(-1, 196, hd), rnd(27, hd, std=0.1), rnd(27, hd, std=0.1),
        14))
    stream = torch.cuda.current_stream().cuda_stream
    # per kernel: the package entry, and the C arguments with their output
    entries = {
        "K2": (lambda: sa.sam_window_attention_v3(q4, k4, v4, rh4, rw4),
               torch.empty(550, 196, heads * hd, dtype=torch.bfloat16,
                           device="cuda"),
               lambda out: sa.window_args(q4, k4, v4, rh4, rw4, out)),
        "K7": (lambda: sa.sam_window_attention_v1(q, k, v, rh, rw),
               torch.empty(550, heads, 196, hd, dtype=torch.bfloat16,
                           device="cuda"),
               lambda out: sa.bias_args(q, k, v, rh, rw, out))}

    def runner(lib, kid):
        kernel = KERNELS[kid]
        fn = getattr(lib, kernel.symbol)
        fn.argtypes, fn.restype = kernel.argtypes, ctypes.c_int
        _, out, make_args = entries[kid]
        args = make_args(out)

        def call():
            err = fn(*args, stream)
            if err:
                raise RuntimeError(f"{kernel.symbol}: cudaError_t {err}")
            return out
        return call

    for kid, (entry, _, _) in entries.items():
        source = KERNELS[kid].source
        if not torch.equal(runner(libs[0][source], kid)(), entry()):
            raise SystemExit(f"{kid}: the whole build differs from the "
                             f"package's kernel")
        for label, row in zip([r[0] for r in ROWS] + ["whole"],
                              libs + [libs[0]]):
            ms = device_ms(runner(row[source], kid), 20)
            print(f"{kid} {label:16s} {ms:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
