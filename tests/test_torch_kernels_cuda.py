"""The port's CUDA kernels K1-K9 against their plain versions, on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  The file imports no JAX, so it runs on a machine with only PyTorch;
tests/conftest.py imports JAX, hence ``--noconftest``:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances, |kernel - plain| <= atol + rtol·|plain|: f32 1e-4 (sums in
other orders), bf16 2e-2 (bf16 output rounding; both round the softmax
weights to bf16 before PV, the kernel before normalising, the plain version
after).
"""
import ctypes
import os
import subprocess

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lameness_tpu_torch.ops import _cuda
from lameness_tpu_torch.ops import attention as at
from lameness_tpu_torch.ops import sam_attention as sa
from lameness_tpu_torch.ops._cuda import KERNELS

pytestmark = pytest.mark.cuda

DTYPES = [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _rnd(dev, dtype, *shape, seed=0, s=1.0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(*shape, generator=g, device=dev) * s).to(dtype)


def _alone(fn, record):
    """fn()'s output, after checking that the call launched ``record``'s
    kernel once, no other kernel of the port, and (torch.profiler) nothing
    else on the card: no copy, no operand build."""
    before = {name: k.launches for name, k in KERNELS.items()}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    launched = {name: k.launches - before[name] for name, k in KERNELS.items()
                if k.launches != before[name]}
    assert launched == {record.name: 1}
    others = {e.key for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and "lameness::" not in e.key}
    assert not others, others
    return out


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("seq,hd", [(257, 64), (70, 16), (33, 128)])
def test_attention_kernel(dev, dtype, tol, seq, hd):
    x = _rnd(dev, dtype, 3, seq, 3, 4, hd)
    q, k, v = (x[:, :, i].transpose(1, 2) for i in range(3))
    before = at.KERNEL.launches
    got = at.flash_attention(q, k, v)
    assert at.KERNEL.launches == before + 1
    ref = at.reference_attention(q, k, v)
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)


def _dino_qkv(dev, b, h, n, layout, dtype=torch.bfloat16):
    """K1's q, k, v (B, H, n, 64): head-last views of three separate
    (B, n, H·64) tensors, as the DINO layer passes its Linear outputs, or
    contiguous (B, H, n, 64) tensors."""
    if layout == "head_last":
        return tuple(_rnd(dev, dtype, b, n, h, 64, seed=i).transpose(1, 2)
                     for i in range(3))
    return tuple(_rnd(dev, dtype, b, h, n, 64, seed=i) for i in range(3))


@pytest.fixture(scope="module")
def mma_route():
    """K1's C entry built with -DLAMENESS_EMULATION, under which
    dino_entry leaves the Hopper routine out: attention.cuh's route for
    every shape, on the same arguments."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    lib = _cuda.BUILD_DIR / "tests" / f"libattention_mma.{os.getpid()}.so"
    lib.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-DLAMENESS_EMULATION",
                    "-o", str(lib), str(_cuda.CSRC / "attention.cu")],
                   check=True, capture_output=True, timeout=600)
    fn = getattr(ctypes.CDLL(str(lib)), at.KERNEL.symbol)
    fn.argtypes, fn.restype = at.KERNEL.argtypes, ctypes.c_int

    def call(q, k, v):
        b, h, s, d = q.shape
        out = torch.empty((b, s, h, d), dtype=q.dtype,
                          device=q.device).transpose(1, 2)
        err = fn(*at.attention_args(q, k, v, out, d ** -0.5),
                 torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"cudaError_t {err}"
        return out
    yield call
    lib.unlink()


def test_dino_route_engine_shape(dev, mma_route):
    """K1 at the full-width engine's shape, B = 2 clips of 5 DINO frames:
    (10, 12, 257, 64) bf16 head-last views, on the Hopper routine
    (dino_attention.cuh).  The entry launches its kernel alone; the output
    agrees with the plain version and with attention.cuh's route, and two
    calls give it bit for bit."""
    q, k, v = _dino_qkv(dev, 10, 12, 257, "head_last")
    got = _alone(lambda: at.flash_attention(q, k, v), at.KERNEL)
    ref = at.reference_attention(q, k, v)
    torch.testing.assert_close(got.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(got.float(), mma_route(q, k, v).float(),
                               atol=2e-2, rtol=2e-2)
    assert torch.equal(got, at.flash_attention(q, k, v))


@pytest.mark.parametrize("layout", ["head_last", "contiguous"])
@pytest.mark.parametrize("n", [1, 8, 63, 64, 65, 136, 137, 255, 256, 257,
                               258, 272, 273])
def test_dino_route_token_counts(dev, mma_route, n, layout):
    """bf16 at head dim 64 around every boundary of the Hopper routine: an
    8-key n-tile (8), a 64-row tile (63-65), a 136-row TMA box (136, 137),
    a 128-key block of QKᵀ (255-258), the 272 keys it holds, and one past
    them (273: attention.cuh's route, equal to it bit for bit).  Against
    the plain version and against attention.cuh's route within the bf16
    tolerance."""
    q, k, v = _dino_qkv(dev, 2, 3, n, layout)
    got = _alone(lambda: at.flash_attention(q, k, v), at.KERNEL)
    ref = at.reference_attention(q, k, v)
    torch.testing.assert_close(got.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)
    mma = mma_route(q, k, v)
    torch.testing.assert_close(got.float(), mma.float(), atol=2e-2,
                               rtol=2e-2)
    if n > 272:
        assert torch.equal(got, mma)


@pytest.mark.parametrize("fault", ["address", "stride"])
def test_dino_route_misaligned(dev, fault):
    """bf16 operands that TMA cannot read -- an address 2 bytes off 16, or
    a token stride of 772 elements (1544 bytes) -- raise in the wrapper
    before any launch, and the C entry itself returns cudaErrorInvalidValue
    (1): no route gives an answer for them."""
    q, k, v = _dino_qkv(dev, 2, 3, 257, "head_last")
    if fault == "address":
        bad = torch.empty(q.numel() + 1, dtype=q.dtype, device=dev)[1:]
        bad = bad.view(2, 257, 3, 64).copy_(q.transpose(1, 2)).transpose(1, 2)
    else:
        bad = torch.zeros(2, 257, 3 * 64 + 4, dtype=q.dtype, device=dev)
        bad = bad[..., :3 * 64].unflatten(-1, (3, 64)).transpose(1, 2)
        bad.copy_(q)
    before = at.KERNEL.launches
    with pytest.raises(ValueError, match="16-byte"):
        at.flash_attention(bad, k, v)
    out = torch.empty(2, 257, 3, 64, dtype=q.dtype, device=dev).transpose(1, 2)
    with pytest.raises(RuntimeError, match="cudaError_t 1$"):
        at.KERNEL(*at.attention_args(bad, k, v, out, 0.125))
    assert at.KERNEL.launches == before


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("win,hd", [(14, 64), (7, 32)])
def test_window_kernel(dev, dtype, tol, win, hd):
    qkv = _rnd(dev, dtype, 5, win * win, 3, 3, hd)
    q4, k4, v4 = qkv.unbind(2)
    rh4, rw4 = sa.project_rel_tables_hl(
        q4, _rnd(dev, dtype, 2 * win - 1, hd, seed=1, s=0.1),
        _rnd(dev, dtype, 2 * win - 1, hd, seed=2, s=0.1), win)
    before = sa.WINDOW_KERNEL.launches
    got = sa.sam_window_attention_v3(q4, k4, v4, rh4, rw4)
    assert sa.WINDOW_KERNEL.launches == before + 1
    ref = sa.window_attention_reference(q4, k4, v4, rh4, rw4)
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)


# the head dim 80 grids: the engine's 64 x 64 (4096 queries: a partial last
# block of 64 of 192 rows), the rect canvas's (36, 64), and 20 x 30 (600
# queries: a last block of 24 rows, a ragged key tile, rh and rw gathered)
HD80_GRIDS = [(64, 64, 80), (36, 64, 80), (20, 30, 80)]


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("gh,gw,hd", [(64, 64, 64), (24, 40, 64)] + HD80_GRIDS)
def test_global_kernel(dev, dtype, tol, gh, gw, hd, monkeypatch):
    """K3 through the switch's default."""
    monkeypatch.delenv("LAMENESS_GLB_KERNEL", raising=False)
    q, k, v = (_rnd(dev, dtype, 3, gh * gw, hd, seed=i) for i in range(3))
    rh, rw = sa.project_rel_tables(
        q, _rnd(dev, dtype, 2 * gh - 1, hd, seed=3, s=0.1),
        _rnd(dev, dtype, 2 * gw - 1, hd, seed=4, s=0.1), gh, gw)
    got = _alone(lambda: sa.sam_global_attention(q, k, v, rh, rw),
                 sa.GLOBAL_KERNEL)
    ref = sa.sam_attention_reference(q, k, v, rh, rw)
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)


def _global_inputs(dev, dtype, gh, gw, hd, heads=3):
    q, k, v = (_rnd(dev, dtype, heads, gh * gw, hd, seed=i) for i in range(3))
    rh, rw = sa.project_rel_tables(
        q, _rnd(dev, dtype, 2 * gh - 1, hd, seed=3, s=0.1),
        _rnd(dev, dtype, 2 * gw - 1, hd, seed=4, s=0.1), gh, gw)
    return q, k, v, rh, rw


def _global_plain(entry, q, k, v, rh, rw):
    """K3's and K4's plain version, or K5's on the augmented operands."""
    if entry != "sam_global_attention_v2":
        return sa.sam_attention_reference(q, k, v, rh, rw)
    qa, ka, rwf = sa.global_v2_operands(q, k, rh, rw)
    return sa.augmented_attention_reference(qa, ka, v, rwf)


GLOBAL_ENTRIES = [("sam_global_attention_v4", "GLOBAL_KERNEL"),       # K3
                  ("sam_global_attention_v1", "GLOBAL_V1_KERNEL"),    # K4
                  ("sam_global_attention_v2", "GLOBAL_V2_KERNEL")]    # K5


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("gh,gw,hd,heads", [
    (64, 64, 64, 3),      # the engine's grid: rw in registers (bf16)
    (24, 40, 64, 3),      # N = 960: a ragged key tile, rh and rw gathered
    (48, 48, 80, 3),      # SAM ViT-H's head dim: 2304 queries, gathered
    (64, 64, 80, 3),      # ViT-H's grid: rw per column, 2 K/V stages
    (36, 64, 80, 3),      # the rect canvas's grid at hd 80
    (20, 30, 80, 3),      # hd 80: a last query block of 24 rows
    (72, 72, 64, 2),      # bias rows past kHopMaxSmem: the mma.sync route
    (7, 9, 64, 5)])       # N = 63 < one key tile, several heads
@pytest.mark.parametrize("entry,kernel", GLOBAL_ENTRIES)
def test_global_variant_kernels(dev, dtype, tol, gh, gw, hd, heads, entry,
                                kernel):
    """K3, K4 and K5 on both routes (bf16 at hd 64 and 80 but the 72 x 72
    grid: the Hopper routine; float32 and the 72 x 72 grid: attention.cuh),
    the tables where the einsum leaves them."""
    q, k, v, rh, rw = _global_inputs(dev, dtype, gh, gw, hd, heads)
    got = _alone(lambda: getattr(sa, entry)(q, k, v, rh, rw),
                 getattr(sa, kernel))
    ref = _global_plain(entry, q, k, v, rh, rw)
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("gh,gw", [(64, 64), (20, 30)])
@pytest.mark.parametrize("entry,kernel", GLOBAL_ENTRIES)
def test_global_kernels_strided(dev, dtype, tol, gh, gw, entry, kernel):
    """K3, K4 and K5 on q, k, v read in place from a fused (BH, N, 3, 64)
    tensor (the TMA maps take the token stride of 192 elements and the head
    stride) and the tables grid-major, as the einsum leaves them."""
    n = gh * gw
    qkv = _rnd(dev, dtype, 4, n, 3, 64)
    q, k, v = qkv.unbind(2)
    rh, rw = sa.project_rel_tables(
        q, _rnd(dev, dtype, 2 * gh - 1, 64, seed=3, s=0.1),
        _rnd(dev, dtype, 2 * gw - 1, 64, seed=4, s=0.1), gh, gw)
    assert rh.stride(1) != gw * rh.stride(2)      # not token-contiguous
    got = _alone(lambda: getattr(sa, entry)(q, k, v, rh, rw),
                 getattr(sa, kernel))
    ref = _global_plain(entry, q, k, v, rh, rw)
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("gh,gw,hd", [(64, 64, 64), (48, 48, 80)] + HD80_GRIDS)
def test_global_kernels_bitwise(dev, gh, gw, hd):
    """K3, K4 and K5 launch one device routine on one set of operands: bf16
    outputs equal bit for bit on the Hopper route, at the engine's (3, 4096,
    64), at head dim 80 and on the rect and ragged grids."""
    args = _global_inputs(dev, torch.bfloat16, gh, gw, hd)
    outs = [_alone(lambda: getattr(sa, entry)(*args), getattr(sa, kernel))
            for entry, kernel in GLOBAL_ENTRIES]
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


def _head_last_inputs(dev, dtype, b, nh, gh, gw, hd):
    """K6's operands as the engine gives them: q4, k4, v4 slices of a fused
    (B, N, 3, nH, hd) qkv output, the tables where project_rel_tables_hl
    leaves them."""
    qkv = _rnd(dev, dtype, b, gh * gw, 3, nh, hd)
    q4, k4, v4 = qkv.unbind(2)
    rh4, rw4 = sa.project_rel_tables_hl(
        q4, _rnd(dev, dtype, 2 * gh - 1, hd, seed=3, s=0.1),
        _rnd(dev, dtype, 2 * gw - 1, hd, seed=4, s=0.1), gh, gw)
    return q4, k4, v4, rh4, rw4


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("b,nh,gh,gw,hd", [
    (2, 12, 64, 64, 64),  # the engine's heads and grid: the Hopper route
    (2, 12, 36, 64, 64),  # the rect canvas's grid
    (2, 2, 24, 40, 64),   # N = 960: a ragged key tile, rh and rw gathered
    (2, 2, 48, 48, 80),   # SAM ViT-H's head dim: 2304 queries, gathered
    (2, 4, 64, 64, 80),   # ViT-H's grid (token stride 3·4·80)
    (2, 4, 36, 64, 80),   # the rect canvas's grid at hd 80
    (1, 2, 20, 30, 80),   # hd 80: a last query block of 24 rows
    (1, 2, 72, 72, 64),   # bias rows past kHopMaxSmem: the mma.sync route
    (3, 1, 7, 9, 64)])    # one head, N = 63 < one key tile
def test_global_head_last_kernel(dev, dtype, tol, b, nh, gh, gw, hd):
    """K6 on strided slices of a fused qkv output, on both routes (bf16 at
    hd 64 and 80 but the 72 x 72 grid: the Hopper routine; float32 and the
    72 x 72 grid: attention.cuh): its entry launches its kernel alone, the
    output agrees with its plain version, and it equals K3's on head-major
    copies of the same q, k, v and tables bit for bit (one routine, one
    function)."""
    q4, k4, v4, rh4, rw4 = _head_last_inputs(dev, dtype, b, nh, gh, gw, hd)
    got = _alone(lambda: sa.sam_global_attention_v3(q4, k4, v4, rh4, rw4),
                 sa.GLOBAL_V3_KERNEL)
    qa, ka, rw = sa.global_v3_operands(q4, k4, rh4, rw4)
    ref = sa.augmented_attention_reference(
        *(t.transpose(1, 2) for t in (qa, ka, v4, rw)))
    ref = ref.transpose(1, 2).reshape(got.shape)
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)
    n = gh * gw

    def head_major(t):
        return t.transpose(1, 2).reshape(b * nh, n, t.shape[-1])
    k3 = sa.sam_global_attention_v4(
        head_major(q4), head_major(k4), head_major(v4),
        head_major(rh4).view(b * nh, gh, gw, gh),
        head_major(rw4).view(b * nh, gh, gw, gw))
    assert torch.equal(got, k3.view(b, nh, n, hd).transpose(1, 2)
                       .reshape(got.shape))


@pytest.mark.parametrize("hd", [64, 80])
def test_global_head_last_misaligned(dev, hd):
    """A bf16 operand that TMA cannot read (an address 2 bytes off 16), at
    head dim 64 and 80: the entry raises before launching, and the C entry
    itself returns cudaErrorInvalidValue (1); nothing takes another
    route."""
    q4, k4, v4, rh4, rw4 = _head_last_inputs(dev, torch.bfloat16, 1, 2, 8,
                                             8, hd)
    bad = torch.empty(q4.numel() + 1, dtype=q4.dtype, device=dev)[1:]
    bad = bad.view(q4.shape).copy_(q4)
    before = sa.GLOBAL_V3_KERNEL.launches
    with pytest.raises(ValueError, match="16-byte"):
        sa.sam_global_attention_v3(bad, k4, v4, rh4, rw4)
    out = torch.empty(1, 64, 2 * hd, dtype=q4.dtype, device=dev)
    with pytest.raises(RuntimeError, match="cudaError_t 1$"):
        sa.GLOBAL_V3_KERNEL(*sa.global_hl_args(bad, k4, v4, rh4, rw4, out))
    assert sa.GLOBAL_V3_KERNEL.launches == before


@pytest.mark.parametrize("dtype,routine", [
    (torch.bfloat16, "hopper_global_kernel<80, true>"),
    (torch.float32, "attention_f32_kernel<80, true>")])
@pytest.mark.parametrize("entry", ["sam_global_attention",
                                   "sam_global_attention_v1",
                                   "sam_global_attention_v2",
                                   "sam_global_attention_v3"])
def test_global_route_at_hd80(dev, dtype, routine, entry, monkeypatch):
    """At ViT-H's head dim 80 and the 64 x 64 grid, global_entry sends bf16
    to the Hopper global routine and float32 to attention.cuh's, for K3
    (the switch's default), K4, K5 and K6 (head-last operands): the one
    kernel the entry launches is that routine's, and no
    attention_mma_kernel runs."""
    monkeypatch.delenv("LAMENESS_GLB_KERNEL", raising=False)
    if entry == "sam_global_attention_v3":
        args = _head_last_inputs(dev, dtype, 1, 2, 64, 64, 80)
    else:
        args = _global_inputs(dev, dtype, 64, 64, 80, heads=2)
    names = _kernel_names(lambda: getattr(sa, entry)(*args))
    assert len(names) == 1 and routine in next(iter(names)), names


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("win,hd", [(14, 64), (14, 80), (8, 16)])
@pytest.mark.parametrize("entry,kernel", [
    ("sam_window_attention_v1", "WINDOW_V1_KERNEL"),         # K7
    ("sam_window_attention_v2", "WINDOW_V2_KERNEL")])        # K8
def test_head_major_window_kernels(dev, dtype, tol, win, hd, entry, kernel):
    """K7 and K8 on head-major views of a fused qkv output."""
    n = win * win
    qkv = _rnd(dev, dtype, 5, n, 3, 3, hd)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    rh, rw = sa.project_rel_tables(
        q.reshape(15, n, hd), _rnd(dev, dtype, 2 * win - 1, hd, seed=1, s=0.1),
        _rnd(dev, dtype, 2 * win - 1, hd, seed=2, s=0.1), win)
    rh, rw = (t.reshape(5, 3, n, win) for t in (rh, rw))
    record = getattr(sa, kernel)
    before = record.launches
    got = getattr(sa, entry)(q, k, v, rh, rw)
    assert record.launches == before + 1
    if entry == "sam_window_attention_v1":
        ref = sa.window_attention_hm_reference(q, k, v, rh, rw)
    else:
        qa, ka = sa.window_v2_operands(q, k, rh, rw)
        ref = sa.augmented_attention_reference(qa, ka, v)
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)


def _window_plain(entry, q, k, v, rh, rw):
    """The plain version of a window entry: K2's and K7's bias
    materialised, K8's and K9's on the augmented operands of their JAX
    entries."""
    if entry == "sam_window_attention_v3":
        return sa.window_attention_reference(q, k, v, rh, rw)
    if entry == "sam_window_attention_v1":
        return sa.window_attention_hm_reference(q, k, v, rh, rw)
    if entry == "sam_window_attention_v2":
        return sa.augmented_attention_reference(
            *sa.window_v2_operands(q, k, rh, rw), v)
    qa, ka = sa.window_v5_operands(q, k, rh, rw)
    out = sa.augmented_attention_reference(
        *(t.transpose(1, 2) for t in (qa, ka, v)), fold=True)
    return out.transpose(1, 2).reshape(v.shape[0], v.shape[1], -1)


# entry, its launch record, and the entry of the same function and layout
# on K2's and K7's kernels (K8 and K9 take their arguments)
WINDOW_ENTRIES = {
    "sam_window_attention_v3": ("WINDOW_KERNEL", None),                # K2
    "sam_window_attention_v1": ("WINDOW_V1_KERNEL", None),             # K7
    "sam_window_attention_v5": ("WINDOW_V5_KERNEL",                    # K9
                                "sam_window_attention_v3"),
    "sam_window_attention_v2": ("WINDOW_V2_KERNEL",                    # K8
                                "sam_window_attention_v1")}


def _window_call(dev, dtype, win, hd, entry):
    """A window entry on head-last slices of a fused qkv output (K2, K9) or
    on their strided head-major views, tables too (K7, K8): its output,
    after checking that it launched its kernel alone, and its plain
    version's.  K8's and K9's output must equal K7's and K2's on the same
    operands bit for bit (one route choice, window_entry, one routine)."""
    qkv = _rnd(dev, dtype, 6, win * win, 3, 4, hd)
    q4, k4, v4 = qkv.unbind(2)
    rh4, rw4 = sa.project_rel_tables_hl(
        q4, _rnd(dev, dtype, 2 * win - 1, hd, seed=1, s=0.1),
        _rnd(dev, dtype, 2 * win - 1, hd, seed=2, s=0.1), win)
    args = (q4, k4, v4, rh4, rw4)
    if entry in ("sam_window_attention_v1", "sam_window_attention_v2"):
        args = tuple(t.transpose(1, 2) for t in args)
    kernel, twin = WINDOW_ENTRIES[entry]
    got = _alone(lambda: getattr(sa, entry)(*args), getattr(sa, kernel))
    if twin is not None:
        assert torch.equal(got, getattr(sa, twin)(*args))
    return got, _window_plain(entry, *args)


@pytest.mark.parametrize("hd", [64, 80])
@pytest.mark.parametrize("win", [14, 7, 8, 16])
@pytest.mark.parametrize("entry", list(WINDOW_ENTRIES))
def test_window_routine(dev, win, hd, entry):
    """bf16 at hd 64 (ViT-B) and 80 (ViT-H): the window routine
    (csrc/window_attention.cuh), one block per (window, head), for K2, K7,
    K8 and K9.  win 14: SAM's 196 tokens in 13 key tiles (at hd 80 each
    warp fetches its next m-tile's Q rows); win 7: 49 tokens, 15 of 64
    padded keys masked, tables read element by element (odd rows); win 16:
    256 tokens, the largest window it takes."""
    got, ref = _window_call(dev, torch.bfloat16, win, hd, entry)
    torch.testing.assert_close(got.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)


def _kernel_names(fn) -> set:
    """The device kernels one call of fn runs, by torch.profiler."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


@pytest.mark.parametrize("dtype,routine", [
    (torch.bfloat16, "window_attention_kernel<80, 13>"),
    (torch.float32, "attention_f32_kernel<80, true>")])
@pytest.mark.parametrize("entry", list(WINDOW_ENTRIES))
def test_window_route_at_hd80(dev, dtype, routine, entry):
    """At ViT-H's head dim 80 and SAM's 14 x 14 window, window_entry sends
    bf16 to the window routine and float32 to attention.cuh's, for K2, K7,
    K8 and K9: the one kernel the entry launches is that routine's, and no
    attention_mma_kernel runs."""
    qkv = _rnd(dev, dtype, 2, 196, 3, 2, 80)
    q4, k4, v4 = qkv.unbind(2)
    rh4, rw4 = sa.project_rel_tables_hl(
        q4, _rnd(dev, dtype, 27, 80, seed=1, s=0.1),
        _rnd(dev, dtype, 27, 80, seed=2, s=0.1), 14)
    args = (q4, k4, v4, rh4, rw4)
    if entry in ("sam_window_attention_v1", "sam_window_attention_v2"):
        args = tuple(t.transpose(1, 2) for t in args)
    names = _kernel_names(lambda: getattr(sa, entry)(*args))
    assert len(names) == 1 and routine in next(iter(names)), names


@pytest.mark.parametrize("dtype,tol,win,hd", [
    (torch.float32, 1e-4, 14, 32), (torch.bfloat16, 2e-2, 14, 32),
    (torch.float32, 1e-4, 14, 64), (torch.bfloat16, 2e-2, 17, 64)])
@pytest.mark.parametrize("entry", list(WINDOW_ENTRIES))
def test_window_off_route(dev, dtype, tol, win, hd, entry):
    """Shapes off the window routine keep attention.cuh's, for K2, K7, K8
    and K9: float32, hd 32, and a 17 x 17 window (289 tokens, 34 bias
    columns)."""
    got, ref = _window_call(dev, dtype, win, hd, entry)
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("win,hd", [(14, 64), (14, 80), (8, 16)])
def test_head_last_window_v5_kernel(dev, dtype, tol, win, hd):
    """K9 on strided slices of a fused qkv output."""
    qkv = _rnd(dev, dtype, 5, win * win, 3, 3, hd)
    q4, k4, v4 = qkv.unbind(2)
    rh4, rw4 = sa.project_rel_tables_hl(
        q4, _rnd(dev, dtype, 2 * win - 1, hd, seed=1, s=0.1),
        _rnd(dev, dtype, 2 * win - 1, hd, seed=2, s=0.1), win)
    before = sa.WINDOW_V5_KERNEL.launches
    got = sa.sam_window_attention_v5(q4, k4, v4, rh4, rw4)
    assert sa.WINDOW_V5_KERNEL.launches == before + 1
    qa, ka = sa.window_v5_operands(q4, k4, rh4, rw4)
    ref = sa.augmented_attention_reference(
        *(t.transpose(1, 2) for t in (qa, ka, v4)), fold=True)
    ref = ref.transpose(1, 2).reshape(got.shape)
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)


def test_cuda_wrappers_reject_bad_operands(dev):
    q = torch.zeros(2, 4, 16, 48, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        at.flash_attention(q, q, q)
    q = torch.zeros(2, 4, 16, 64, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError, match="dtype"):
        at.flash_attention(q, q, q)
    q = torch.zeros(2, 4, 16, 65, device=dev, dtype=torch.bfloat16)[..., 1:]
    with pytest.raises(ValueError, match="16-byte"):
        at.flash_attention(q, q, q)
    # K8 and K9: a bf16 operand 2 bytes off 16-byte alignment raises before
    # any launch (the 17 x 17 window they once refused is in
    # test_window_off_route)
    qkv = torch.zeros(1, 16, 3, 2, 64, device=dev, dtype=torch.bfloat16)
    q4, k4, v4 = qkv.unbind(2)
    rh4 = torch.zeros(1, 16, 2, 4, device=dev, dtype=torch.bfloat16)
    bad = torch.empty(q4.numel() + 1, dtype=q4.dtype, device=dev)[1:]
    bad = bad.view(q4.shape)
    for entry, kernel, hm in (("sam_window_attention_v5", sa.WINDOW_V5_KERNEL,
                               False),
                              ("sam_window_attention_v2", sa.WINDOW_V2_KERNEL,
                               True)):
        args = (bad, k4, v4, rh4, rh4)
        if hm:
            args = tuple(t.transpose(1, 2) for t in args)
        before = kernel.launches
        with pytest.raises(ValueError, match="16-byte"):
            getattr(sa, entry)(*args)
        assert kernel.launches == before


@pytest.mark.parametrize("entry", [
    "flash_attention", "sam_window_attention_v3", "sam_window_attention_v1",
    "sam_window_attention_v2", "sam_window_attention_v5",
    "sam_global_attention_v4", "sam_global_attention_v1",
    "sam_global_attention_v2", "sam_global_attention_v3"])
def test_cuda_wrappers_refuse_gradients(dev, entry):
    """K1-K9 have no backward: under grad mode, an operand that requires
    grad raises before any launch (a detached output would leave the
    weights before the kernel without a gradient, silently); under
    no_grad the same call launches."""
    f = torch.float32
    if entry == "flash_attention":
        args = [_rnd(dev, f, 1, 2, 16, 64, seed=i) for i in range(3)]
        call = at.flash_attention
    elif entry in ("sam_window_attention_v3", "sam_window_attention_v5"):
        # 7 x 7 windows, (BW, N, nH, hd) and (BW, N, nH, win)
        args = [_rnd(dev, f, 2, 49, 2, 64, seed=i) for i in range(3)] + \
            [_rnd(dev, f, 2, 49, 2, 7, seed=3 + i) for i in range(2)]
        call = getattr(sa, entry)
    elif entry.startswith("sam_window"):
        args = [_rnd(dev, f, 2, 2, 49, 64, seed=i) for i in range(3)] + \
            [_rnd(dev, f, 2, 2, 49, 7, seed=3 + i) for i in range(2)]
        call = getattr(sa, entry)
    elif entry == "sam_global_attention_v3":
        # a 7 x 9 grid, (B, N, nH, hd), (B, N, nH, GH) and (B, N, nH, GW)
        args = [_rnd(dev, f, 1, 63, 2, 64, seed=i) for i in range(3)] + \
            [_rnd(dev, f, 1, 63, 2, 7, seed=3),
             _rnd(dev, f, 1, 63, 2, 9, seed=4)]
        call = getattr(sa, entry)
    else:
        args = [_rnd(dev, f, 2, 63, 64, seed=i) for i in range(3)] + \
            [_rnd(dev, f, 2, 7, 9, 7, seed=3), _rnd(dev, f, 2, 7, 9, 9,
                                                   seed=4)]
        call = getattr(sa, entry)
    args[0].requires_grad_(True)
    before = {name: k.launches for name, k in KERNELS.items()}
    with pytest.raises(RuntimeError, match="requires grad"):
        call(*args)
    assert {name: k.launches for name, k in KERNELS.items()} == before
    with torch.no_grad():
        call(*args)
    assert sum(k.launches for k in KERNELS.values()) == \
        sum(before.values()) + 1
