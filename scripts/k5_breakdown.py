#!/usr/bin/env python3
"""Where K5's time goes on the card: its bf16 device time at the shapes the
full-width engine gives it for B = 2 clips (the 64x64 grid of 4096 tokens;
264 heads of 64 with SAM ViT-B, 352 of 80 with ViT-H), built whole and with
parts of the kernel left out.

    python scripts/k5_breakdown.py        # ViT-B, head dim 64
    python scripts/k5_breakdown.py 80     # ViT-H, head dim 80

The script builds its own copies of ``sam_global_attention_v2`` with nvcc
(one process per row, all together) into
``lameness_tpu_torch/_build/k5_breakdown/``, each from a copy of ``csrc/``
that it edits there; the package's sources and its library stay as they
are.  Each row prints torch.profiler's summed device time of the port's
kernel over 5 calls:
  whole            the kernel as the engine runs it (wgmma + TMA route); its
                   output must equal the package entry's, bit for bit;
  mma.sync route   -DLAMENESS_EMULATION: the C entry takes the routine of
                   attention.cuh on the same direct operands (what K3 and
                   K4 ran before they took the Hopper routine);
  no softmax       TMA, bias staging and products;
  no products      TMA, bias staging and softmax;
  K/V stream only  TMA and bias staging;
and at head dim 80 two other builds, whose output must equal the whole
kernel's bit for bit (a row's sums run in the same order):
  192 rows x 2     the block shape the routine did not keep: three
                   consumer warpgroups (192 query rows, 160 registers a
                   thread) and 2 K/V stages in place of two (128 rows, 240
                   registers) and 3;
  rw from shared   the rw values of the 64-column grid read from shared
                   memory each tile, as at hd 64, not held in registers.
The stubbed copies compute wrong results; they are timings only.  The whole
kernel runs first and last, so that a drift of the card shows.  The card's
name and power limit come first, and per row ptxas's registers and spills
of the routine's instantiation at the head dim.
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from lameness_tpu_torch.ops import _cuda  # noqa: E402
from lameness_tpu_torch.ops import sam_attention as sa  # noqa: E402

OUT = _cuda.BUILD_DIR / "k5_breakdown"
SOURCE = sa.GLOBAL_V2_KERNEL.source
# a stub: the opening line of a lambda of consume() in hopper_attention.cuh,
# and the early return put after it
_NO_PRODUCTS = (("auto issue_qk = [&](int stage) {", "wgmma_commit(); return;"),
                ("auto issue_pv = [&](int stage) {", "wgmma_commit(); return;"))
_NO_SOFTMAX = (("auto softmax = [&](int it) {",
                "alpha[0] = alpha[1] = 1.f; return;"),)
# the other block shape at hd 80, in place of HopShape<80>'s
_OTHER_SHAPE = (("kBlockQ = 128, kStages = 3;",
                 "kBlockQ = 192, kStages = 2;", True),)
# the rw values read from shared memory each tile, as three warpgroups do
_RW_SHARED = (("constexpr bool RW_REGS = ROW_TILE && C::kRegs >= 240;",
               "constexpr bool RW_REGS = false;", True),)
# label, extra nvcc flags, stubs
ROWS = (("whole", (), ()),
        ("mma.sync route", ("-DLAMENESS_EMULATION",), ()),
        ("no softmax", (), _NO_SOFTMAX),
        ("no products", (), _NO_PRODUCTS),
        ("K/V stream only", (), _NO_SOFTMAX + _NO_PRODUCTS))
ROWS_80 = ROWS + (("192 rows x 2", (), _OTHER_SHAPE),
                  ("rw from shared", (), _RW_SHARED))


def build(sources=(SOURCE,), header: str = "hopper_attention.cuh",
          rows=ROWS, out=OUT) -> list:
    """One library per row and source, each from its own copy of ``csrc/``
    with the row's stubs put into its copy of ``header``: nvcc all
    together.  A stub (anchor, line) puts the line after the anchor; (anchor,
    text, True) puts the text in the anchor's place.  Returns, per row,
    {source: library}."""
    shutil.rmtree(out, ignore_errors=True)
    procs = []
    for i, (label, flags, stubs) in enumerate(rows):
        src = out / f"src{i}"
        src.mkdir(parents=True)
        for f in (*_cuda.CSRC.glob("*.cuh"),
                  *(_cuda.CSRC / f"{s}.cu" for s in sources)):
            shutil.copy(f, src / f.name)
        path = src / header
        text = path.read_text()
        for anchor, stub, *replace in stubs:
            if text.count(anchor) != 1:
                raise SystemExit(f"{label}: '{anchor}' is not in {header} "
                                 f"exactly once")
            text = text.replace(anchor, stub if replace else
                                f"{anchor}\n    {stub}")
        path.write_text(text)
        for s in sources:
            lib = out / f"lib{s}-{i}.so"
            cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, *flags, "-o", str(lib),
                   str(src / f"{s}.cu")]
            procs.append((i, label, s, lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    _cuda.build(sources)     # the package's own, for the bitwise check
    libs = [{} for _ in rows]
    for i, label, s, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{label} {s}: nvcc exit {proc.returncode}\n"
                             f"{log}")
        lib.with_suffix(".log").write_text(log)    # ptxas -v
        libs[i][s] = ctypes.CDLL(str(lib))
    return libs


def card() -> None:
    """The card's name and power limit, first."""
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)


def device_ms(call, reps: int) -> float:
    """torch.profiler's summed device time of the port's kernels
    (``lameness::``) over ``reps`` calls, per call, after one warm call."""
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and "lameness::" in e.key)
    return us / reps / 1e3


def main() -> int:
    hd = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    heads = {64: 264, 80: 352}[hd]
    rows = ROWS_80 if hd == 80 else ROWS
    card()
    print(f"head dim {hd}, {heads} heads of 4096 tokens", flush=True)
    libs = [row[SOURCE] for row in build(rows=rows)]
    for (label, *_), lib in zip(rows, libs):
        for e in _cuda.ptxas_entries(Path(lib._name).with_suffix(".log")
                                     .read_text()):
            if f"hopper_global_kernelILi{hd}ELb1" in e["name"]:
                print(f"ptxas {label:16s} {e['registers']}; {e['spills']}",
                      flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * std
                ).to(torch.bfloat16)
    q, k, v = (rnd(heads, 4096, hd) for _ in range(3))
    rh, rw = sa.project_rel_tables(q, rnd(127, hd, std=0.1),
                                   rnd(127, hd, std=0.1), 64)
    stream = torch.cuda.current_stream().cuda_stream
    kernel = sa.GLOBAL_V2_KERNEL

    def runner(lib):
        fn = getattr(lib, kernel.symbol)
        fn.argtypes, fn.restype = kernel.argtypes, ctypes.c_int
        # the tables as the package entry passes them, to either route
        out = torch.empty_like(q)
        args = sa.global_args(q, k, v, rh, rw, out)

        def call():
            err = fn(*args, stream)
            if err:
                raise RuntimeError(f"{kernel.symbol}: cudaError_t {err}")
            return out
        return call

    whole = runner(libs[0])
    if not torch.equal(whole(), sa.sam_global_attention_v2(q, k, v, rh, rw)):
        raise SystemExit("the whole build differs from the package's kernel")
    for label, lib in zip([r[0] for r in rows[5:]], libs[5:]):
        if not torch.equal(runner(lib)(), whole()):
            raise SystemExit(f"{label} differs from the whole kernel")
    for label, lib in zip([r[0] for r in rows] + ["whole"],
                          libs + [libs[0]]):
        print(f"K5 {label:16s} {device_ms(runner(lib), 5):.4f} ms",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
