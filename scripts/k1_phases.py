#!/usr/bin/env python3
"""Where each of K1's query tiles spends its time on the card: the SM clock
at each phase of the Hopper routine (csrc/dino_attention.cuh), per
warpgroup and tile, at the shape the full-width engine gives K1 for B = 2
clips (10 frames x 12 heads of 257 tokens, head dim 64, head-last views).

    python scripts/k1_phases.py

The method of ``scripts/k5_breakdown.py``, whose build it uses: one copy of
``attention`` built with nvcc into ``lameness_tpu_torch/_build/k1_phases/``
from a copy of ``csrc/`` whose ``dino_attention.cuh`` has clock64() stamps
put in (the package's sources and library stay as they are).  Each block
of the first 120 records, per warpgroup and tile, the clocks since the
block started at: the tile's start, Q and K in, QKᵀ done, softmax done, V
in, PV done, the output stored (its TMA store issued); and when the
warpgroup is done.  The script prints the median over the blocks, for one
call with the inputs in L2 (after a call on them) and one after 64 MB of
writes have pushed them out.  The stamps cost a few instructions per
phase; the output must still equal the package entry's bit for bit.  The
card's name and power limit come first.
"""
from __future__ import annotations

import ctypes
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from k5_breakdown import build, card  # noqa: E402
from lameness_tpu_torch.ops import attention as at  # noqa: E402
from lameness_tpu_torch.ops import _cuda  # noqa: E402

OUT = _cuda.BUILD_DIR / "k1_phases"
PHASES = ("start", "Q, K in", "QK done", "softmax done", "V in", "PV done",
          "stored")
# stamps[block][warpgroup][slot][phase]: slot = tile / 2 (tiles 0, 2, 4 of
# warpgroup 0 and 1, 3 of warpgroup 1); phase 7 of slot 0 of warpgroup 0
# holds the block's start, of slot 2 each warpgroup's end
_GLOBALS = """
__device__ unsigned long long k1_stamps[120][2][3][8];
#define K1_STAMP(k, slot)                                                \\
  if (threadIdx.x % 128 == 0 && blockIdx.x < 120)                         \\
    k1_stamps[blockIdx.x][threadIdx.x / 128][slot][k] = clock64()
#define STAMP(k) K1_STAMP(k, (q0 / 64) / 2)
extern "C" int k1_read_stamps(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, k1_stamps, sizeof(k1_stamps));
}
"""
STAMPS = (
    ("namespace lameness {", "namespace lameness {" + _GLOBALS, True),
    ("  mbar_wait(bar_q, 0);\n  mbar_wait(bar_k, 0);\n"
     "  dino_qk(s, q_tile, k_s);",
     "  STAMP(0);\n  mbar_wait(bar_q, 0);\n  mbar_wait(bar_k, 0);\n"
     "  STAMP(1);\n  dino_qk(s, q_tile, k_s);\n  STAMP(2);", True),
    ("  mbar_wait(bar_v, 0);\n  dino_pv(o, p, v_s);",
     "  STAMP(3);\n  mbar_wait(bar_v, 0);\n  STAMP(4);\n"
     "  dino_pv(o, p, v_s);\n  STAMP(5);", True),
    ("    bulk_commit();\n  }\n}", "    bulk_commit();\n  }\n  STAMP(6);\n}",
     True),
    ("  const int tiles = min(kDinoTiles, (a.n_q + 63) / 64 - tile0);",
     "  const int tiles = min(kDinoTiles, (a.n_q + 63) / 64 - tile0);\n"
     "  if (threadIdx.x == 0) K1_STAMP(7, 0);", True),
    ("  if (threadIdx.x % 128 == 0) bulk_wait_read();",
     "  if (threadIdx.x % 128 == 0) bulk_wait_read();\n  K1_STAMP(7, 2);",
     True),
)


def main() -> int:
    card()
    source = at.KERNEL.source
    lib = build((source,), "dino_attention.cuh",
                (("stamped", (), STAMPS),), OUT)[0][source]
    fn = getattr(lib, at.KERNEL.symbol)
    fn.argtypes, fn.restype = at.KERNEL.argtypes, ctypes.c_int
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(10, 257, 12, 64, generator=gen, device="cuda")
               .to(torch.bfloat16).transpose(1, 2) for _ in range(3))
    out = torch.empty(10, 257, 12, 64, dtype=q.dtype,
                      device="cuda").transpose(1, 2)
    args = at.attention_args(q, k, v, out, 64 ** -0.5)
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        err = fn(*args, stream)
        if err:
            raise RuntimeError(f"{at.KERNEL.symbol}: cudaError_t {err}")
    call()
    torch.cuda.synchronize()
    if not torch.equal(out, at.flash_attention(q, k, v)):
        raise SystemExit("the stamped build differs from the package's")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for label in ("inputs in L2", "inputs pushed out of L2"):
        if label == "inputs in L2":
            call()
        else:
            flush.zero_()
        torch.cuda.synchronize()
        call()
        torch.cuda.synchronize()
        st = np.zeros((120, 2, 3, 8), np.uint64)
        err = lib.k1_read_stamps(st.ctypes.data_as(ctypes.c_void_p))
        if err:
            raise RuntimeError(f"k1_read_stamps: cudaError_t {err}")
        rel = st.astype(np.int64) - st[:, 0, 0, 7].astype(np.int64)[
            :, None, None, None]
        print(f"K1 phases, {label}: median SM clocks since the block "
              f"started (median of the first 120 blocks)", flush=True)
        for wg, slots in ((0, 3), (1, 2)):
            for slot in range(slots):
                med = np.median(rel[:, wg, slot, :7], axis=0).astype(int)
                print(f"  warpgroup {wg} tile {2 * slot + wg}: " + "  ".join(
                    f"{name} {m}" for name, m in zip(PHASES, med)))
        print("  done: " + "  ".join(
            f"warpgroup {wg} {int(np.median(rel[:, wg, 2, 7]))}"
            for wg in (0, 1)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
