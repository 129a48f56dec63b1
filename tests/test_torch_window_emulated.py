"""The window routine (``csrc/window_attention.cuh``) rehearsed on the CPU.

g++ builds K2's and K7's sources (``sam_window_attention.cu``, head-last,
and ``sam_window_attention_v1.cu``, head-major) against the CUDA emulation
in ``csrc/emulate/``, as ``scripts/emulate_cuda_kernels.py`` does, and
their C entries, which both choose their route in ``window_entry``, run in
bf16 at head dims 64 and 80 on windows of 7 x 7 (KT = 4 key tiles; the
tables read element by element, odd rows) and 14 x 14 (SAM's 196 tokens,
KT = 13; the tables read by words), against the plain versions.
Tolerance, the emulation script's: |kernel - plain| <= 1e-2 + 1.6e-2·|plain|
(bf16 output rounding; the kernel rounds the unnormalised softmax weights
to bf16, the plain version the normalised ones).  Skips without g++.
"""
import ctypes
import importlib.util
import shutil
from pathlib import Path

import pytest
import torch

from lameness_tpu_torch.ops import sam_attention as sa

ROOT = Path(__file__).resolve().parents[1]
ATOL, RTOL = 1e-2, 1.6e-2
SOURCES = ("sam_window_attention", "sam_window_attention_v1")


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the CUDA emulation")
    spec = importlib.util.spec_from_file_location(
        "emulate_cuda_kernels", ROOT / "scripts" / "emulate_cuda_kernels.py")
    emu = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(emu)
    return emu.build(SOURCES, tmp_path_factory.mktemp("window_emulated"))


def _call(lib, kernel, args):
    fn = getattr(lib, kernel.symbol)
    fn.argtypes, fn.restype = kernel.argtypes, ctypes.c_int
    assert fn(*args, None) == 0


@pytest.mark.parametrize("layout", ["head_last", "head_major"])
@pytest.mark.parametrize("win,heads", [(7, 2), (14, 1)])
@pytest.mark.parametrize("hd", [64, 80])
def test_window_entry_emulated(lib, hd, win, heads, layout):
    """K2 on head-last slices of a fused qkv output, K7 on their head-major
    views (one window, ``heads`` window-heads)."""
    gen = torch.Generator().manual_seed(hd + win)

    def rnd(*shape, s=1.0):
        return (torch.randn(*shape, generator=gen) * s).to(torch.bfloat16)
    n = win * win
    q4, k4, v4 = rnd(1, n, 3, heads, hd).unbind(2)
    rh4, rw4 = sa.project_rel_tables_hl(q4, rnd(2 * win - 1, hd, s=0.1),
                                        rnd(2 * win - 1, hd, s=0.1), win)
    if layout == "head_last":
        out = torch.empty(1, n, heads * hd, dtype=torch.bfloat16)
        _call(lib, sa.WINDOW_KERNEL, sa.window_args(q4, k4, v4, rh4, rw4, out))
        ref = sa.window_attention_reference(q4, k4, v4, rh4, rw4)
    else:
        hm = tuple(t.transpose(1, 2) for t in (q4, k4, v4, rh4, rw4))
        out = torch.empty(1, heads, n, hd, dtype=torch.bfloat16)
        _call(lib, sa.WINDOW_V1_KERNEL, sa.bias_args(*hm, out))
        ref = sa.window_attention_hm_reference(*hm)
    err = (out.float() - ref.float()).abs()
    assert bool((err <= ATOL + RTOL * ref.float().abs()).all()), \
        float(err.max())
