#!/usr/bin/env python3
"""Rehearse the port's CUDA kernels on the CPU, without a GPU or nvcc.

Compiles ``lameness_tpu_torch/csrc/*.cu`` with g++ as plain C++ against the
host emulation in ``lameness_tpu_torch/csrc/emulate/`` (one std::thread per
CUDA thread; ``mma.sync``, ``ldmatrix``, ``cp.async`` and shuffles emulated
with their fragment layouts), loads the library with ctypes and holds each
kernel's C entry point against its plain PyTorch version at small shapes,
in float32 and bfloat16.  A launch takes seconds and the emulation is only
as faithful as its headers: the GPU stays the proof (chip_smoke.py); this
catches indexing, fragment and masking faults before a run there.

    python scripts/emulate_cuda_kernels.py        # exit 0 when all agree
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from lameness_tpu_torch.ops import _cuda  # noqa: E402
from lameness_tpu_torch.ops import attention as at  # noqa: E402
from lameness_tpu_torch.ops import sam_attention as sa  # noqa: E402

EMU = _cuda.CSRC / "emulate"
OUT = _cuda.BUILD_DIR / "emulate"
# |kernel - plain| <= atol + rtol·|plain|, as on the card
TOL = {torch.float32: (2e-5, 0.0), torch.bfloat16: (1e-2, 1.6e-2)}


def build(names=_cuda.SOURCES, out: Path = OUT) -> ctypes.CDLL:
    """g++ the named sources (one process per file, all together) into
    ``out`` and link them into one library."""
    src = out / "src"
    shutil.rmtree(out, ignore_errors=True)
    src.mkdir(parents=True)
    for f in _cuda.CSRC.glob("*.cuh"):
        shutil.copy(f, src / f.name)
    shutil.copy(EMU / "mma.cuh", src / "mma.cuh")     # the emulated twin
    units = [EMU / "shared.cpp"]
    for name in names:
        units.append(src / f"{name}.cpp")
        shutil.copy(_cuda.CSRC / f"{name}.cu", units[-1])
    # LAMENESS_EMULATION: the sources leave out their wgmma/TMA routes
    # (csrc/hopper_attention.cuh, csrc/dino_attention.cuh), which have no
    # emulation
    flags = ["-std=c++20", "-O2", "-fPIC", "-DLAMENESS_EMULATION", f"-I{EMU}",
             f"-I{src}"]
    procs = [subprocess.Popen(["g++", *flags, "-c", str(u), "-o",
                               str(out / f"{u.stem}.o")])
             for u in units]
    if any(p.wait() for p in procs):
        raise SystemExit("emulation build failed")
    lib = out / "libemulated.so"
    subprocess.run(["g++", "-shared", "-o", str(lib),
                    *(str(out / f"{u.stem}.o") for u in units), "-lpthread"],
                   check=True)
    return ctypes.CDLL(str(lib))


def call(lib, kernel, args) -> None:
    fn = getattr(lib, kernel.symbol)
    fn.argtypes, fn.restype = kernel.argtypes, ctypes.c_int
    err = fn(*args, None)
    if err:
        raise RuntimeError(f"{kernel.symbol}: error {err}")


def main() -> int:
    lib = build()
    gen = torch.Generator().manual_seed(0)

    def rnd(*shape, dtype):
        return torch.randn(*shape, generator=gen).to(dtype)
    ok = True

    def report(name, dtype, shape, out, ref):
        nonlocal ok
        atol, rtol = TOL[dtype]
        err = (out.float() - ref.float()).abs()
        good = bool((err <= atol + rtol * ref.float().abs()).all())
        ok &= good
        print(f"{name} {str(dtype):14s} {shape}  max_abs_err "
              f"{float(err.max()):.3e}  {'ok' if good else 'FAIL'}")

    for dtype in (torch.bfloat16, torch.float32):
        # K1: head-last views, S not a multiple of the 64-row blocks; the
        # mma.sync route for every shape (dino_entry leaves the Hopper
        # routine out here, as global_entry does)
        for b, h, s, d in ((1, 2, 70, 32), (2, 1, 33, 64), (1, 1, 5, 80),
                           (1, 1, 257, 64), (1, 1, 130, 128)):
            qkv = rnd(b, s, 3, h, d, dtype=dtype)
            q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
            out = torch.empty(b, s, h, d, dtype=dtype).transpose(1, 2)
            call(lib, at.KERNEL, at.attention_args(q, k, v, out, d ** -0.5))
            report("K1", dtype, (b, h, s, d), out,
                   at.reference_attention(q, k, v))
        # K2: windows with pad tokens (unmasked), fused-qkv slices.  bf16 at
        # hd 64 and 80 takes the window routine (window_attention.cuh):
        # 16-key tiles KT = 4 (win 7, 8), 13 (win 14) and 16 (win 16);
        # tables read by words (even win) or element by element (win 7).
        # The rest: attention.cuh's routine.  K2 and K7 at hd 80:
        # tests/test_torch_window_emulated.py
        for bw, win, nh, hd in ((2, 7, 2, 32), (2, 14, 2, 64), (2, 7, 2, 64),
                                (1, 8, 2, 64), (2, 16, 2, 64)):
            qkv = rnd(bw, win * win, 3, nh, hd, dtype=dtype)
            q4, k4, v4 = qkv.unbind(2)
            rh4, rw4 = sa.project_rel_tables_hl(
                q4, rnd(2 * win - 1, hd, dtype=dtype),
                rnd(2 * win - 1, hd, dtype=dtype), win)
            out = torch.empty(bw, win * win, nh * hd, dtype=dtype)
            call(lib, sa.WINDOW_KERNEL,
                 sa.window_args(q4, k4, v4, rh4, rw4, out))
            report("K2", dtype, (bw, win, nh, hd), out,
                   sa.window_attention_reference(q4, k4, v4, rh4, rw4))
        # K3, K4: rectangular grids (per-score bias gather) and GW = 64 (the
        # key tile is one grid row: rel_w in registers).  The tables as the
        # einsum leaves them: rel_h grid-row-major (grid row stride BH·GW·GH),
        # rel_w grid-column-major, neither token-contiguous where BH > 1
        for name, kernel in (("K3", sa.GLOBAL_KERNEL),
                             ("K4", sa.GLOBAL_V1_KERNEL)):
            for bh, gh, gw, d in ((2, 6, 11, 32), (1, 12, 16, 64),
                                  (1, 3, 64, 32), (2, 2, 64, 64)):
                q, k, v = (rnd(bh, gh * gw, d, dtype=dtype) for _ in range(3))
                rh, rw = sa.project_rel_tables(
                    q, rnd(2 * gh - 1, d, dtype=dtype),
                    rnd(2 * gw - 1, d, dtype=dtype), gh, gw)
                out = torch.empty_like(q)
                call(lib, kernel, sa.global_args(q, k, v, rh, rw, out))
                report(name, dtype, (bh, gh, gw, d), out,
                       sa.sam_attention_reference(q, k, v, rh, rw))
        # K7: head-major windows, q/k/v strided views of a fused qkv output
        # (the window routine at bf16 hd 64 and 80: KT = 4, 13 with N = 144
        # < 208)
        for bw, win, nh, hd in ((2, 7, 2, 32), (1, 14, 2, 64), (1, 5, 1, 80),
                                (2, 7, 2, 64), (1, 12, 2, 64)):
            n = win * win
            qkv = rnd(bw, n, 3, nh, hd, dtype=dtype)
            q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
            rh, rw = sa.project_rel_tables(
                q.reshape(bw * nh, n, hd), rnd(2 * win - 1, hd, dtype=dtype),
                rnd(2 * win - 1, hd, dtype=dtype), win)
            rh, rw = (t.reshape(bw, nh, n, win) for t in (rh, rw))
            out = torch.empty(bw, nh, n, hd, dtype=dtype)
            call(lib, sa.WINDOW_V1_KERNEL, sa.bias_args(q, k, v, rh, rw, out))
            report("K7", dtype, (bw, win, nh, hd), out,
                   sa.window_attention_hm_reference(q, k, v, rh, rw))
        # K6 (head-last) and K5 (head-major) take K3's function on the
        # mma.sync route here (global_entry: no wgmma/TMA in the
        # emulation); their plain versions run on the augmented operands of
        # the JAX entries.  K6 reads q4, k4, v4 as slices of a fused qkv
        # output and the tables where project_rel_tables_hl leaves them;
        # one head (the tables' grid-row stride from the token stride) and
        # several; rh and rw gathered per score, or rw in registers at
        # GW = 64
        for b, nh, gh, gw, d in ((2, 1, 6, 11, 32), (1, 2, 3, 64, 64),
                                 (1, 1, 40, 2, 32), (1, 2, 4, 4, 80),
                                 (2, 3, 5, 7, 64)):
            n = gh * gw
            qkv = rnd(b, n, 3, nh, d, dtype=dtype)
            q4, k4, v4 = qkv.unbind(2)
            tables = (rnd(2 * gh - 1, d, dtype=dtype),
                      rnd(2 * gw - 1, d, dtype=dtype))
            rh4, rw4 = sa.project_rel_tables_hl(q4, *tables, gh, gw)
            out = torch.empty(b, n, nh * d, dtype=dtype)
            call(lib, sa.GLOBAL_V3_KERNEL,
                 sa.global_hl_args(q4, k4, v4, rh4, rw4, out))
            report("K6", dtype, (b, nh, gh, gw, d), out,
                   sa.sam_global_attention_v3(q4, k4, v4, rh4, rw4))
            q, k, v = (t.transpose(1, 2).reshape(b * nh, n, d)
                       for t in (q4, k4, v4))
            rh, rw = sa.project_rel_tables(q, *tables, gh, gw)
            out = torch.empty_like(q)
            call(lib, sa.GLOBAL_V2_KERNEL,
                 sa.global_args(q, k, v, rh, rw, out))
            report("K5", dtype, (b, nh, gh, gw, d), out,
                   sa.sam_global_attention_v2(q, k, v, rh, rw))
        # K9 (head-last, K2's arguments) and K8 (head-major, K7's), through
        # window_entry: the window routine at bf16 hd 64 and 80 (KT = 4, 8,
        # 13; tables by words, or element by element where win is odd),
        # attention.cuh's per-score bias routine otherwise (float32, hd 32
        # and 16, the 17 x 17 window).  Held against the plain versions
        # on the augmented operands of the JAX entries, and bit for bit
        # against K2 and K7 on the same operands
        for bw, win, nh, hd in ((2, 7, 2, 32), (1, 14, 2, 64), (1, 8, 1, 80),
                                (1, 14, 1, 16), (2, 7, 2, 64), (1, 8, 2, 64),
                                (1, 17, 1, 64)):
            n = win * win
            qkv = rnd(bw, n, 3, nh, hd, dtype=dtype)
            q4, k4, v4 = qkv.unbind(2)
            rh4, rw4 = sa.project_rel_tables_hl(
                q4, rnd(2 * win - 1, hd, dtype=dtype),
                rnd(2 * win - 1, hd, dtype=dtype), win)
            hl = (q4, k4, v4, rh4, rw4)
            hm = tuple(t.transpose(1, 2) for t in hl)
            for kid, kernel, twin, args, plain, shape in (
                    ("K9", sa.WINDOW_V5_KERNEL, sa.WINDOW_KERNEL,
                     sa.window_args, sa.sam_window_attention_v5(*hl),
                     (bw, n, nh * hd)),
                    ("K8", sa.WINDOW_V2_KERNEL, sa.WINDOW_V1_KERNEL,
                     sa.bias_args, sa.sam_window_attention_v2(*hm),
                     (bw, nh, n, hd))):
                out, ref = (torch.empty(shape, dtype=dtype) for _ in range(2))
                call(lib, kernel, args(*(hl if kid == "K9" else hm), out))
                call(lib, twin, args(*(hl if kid == "K9" else hm), ref))
                report(kid, dtype, (bw, win, nh, hd), out, plain)
                same = torch.equal(out, ref)
                ok &= same
                print(f"{kid} = {'K2' if kid == 'K9' else 'K7'} bit for bit: "
                      f"{'ok' if same else 'FAIL'}")
    print("emulated kernels:", "ok" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
