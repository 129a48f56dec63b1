"""K4-K9 and the SAM encoder's kernel switches: the port against the JAX
package, on the CPU.

On a CPU tensor each port entry runs its plain version: the bias
materialised (K4, K7), or softmax(qa·kaᵀ (+ rw)) @ v on the augmented
operands the entry builds (K5, K6, K8, K9), so the construction itself is
held against JAX.  The JAX entries run their Pallas kernels in interpret
mode on the same seeded numpy inputs.  Tolerance 3e-5 in float32, the JAX
package's own gate for these kernels (tests/test_sam_attention.py): the two
sides sum in other orders.

The switches ``LAMENESS_WIN_KERNEL`` and ``LAMENESS_GLB_KERNEL`` are read at
each call on both sides.  On the CPU every route gives the same answer, so
the dispatch-table test spies on the port's entries to prove which one each
case reaches.  The CUDA kernels are held against these plain versions by
tests/test_torch_kernels_cuda.py (card only) and chip_smoke.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lameness_tpu.models import sam as jsam
from lameness_tpu.ops import sam_attention as jsa
from lameness_tpu_torch.models import sam as tsam
from lameness_tpu_torch.ops import sam_attention as tsa
from lameness_tpu_torch.weights import from_jax_params

ATOL = 3e-5
SWITCHES = ("LAMENESS_WIN_KERNEL", "LAMENESS_GLB_KERNEL")


@pytest.fixture(autouse=True)
def _no_switches(monkeypatch):
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)


def _set(monkeypatch, win=None, glb=None):
    for name, val in zip(SWITCHES, (win, glb)):
        if val is not None:
            monkeypatch.setenv(name, val)


def _randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def _global(seed, bh, gh, gw, d):
    """(BH, N, D) q, k, v and the projected (BH, GH, GW, ·) tables, as
    (jax, torch) pairs of the same values."""
    rng = np.random.default_rng(seed)
    q, k, v = (_randn(rng, bh, gh * gw, d) for _ in range(3))
    rh, rw = jsa.project_rel_tables(
        jnp.asarray(q), jnp.asarray(_randn(rng, 2 * gh - 1, d, scale=0.2)),
        jnp.asarray(_randn(rng, 2 * gw - 1, d, scale=0.2)), gh, gw)
    arrays = (q, k, v, np.asarray(rh), np.asarray(rw))
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.array(a)) for a in arrays])


def _head_last(seed, b, nh, gh, gw, hd):
    """(B, N, nH, hd) q4, k4, v4 and the head-last tables."""
    rng = np.random.default_rng(seed)
    q4, k4, v4 = (_randn(rng, b, gh * gw, nh, hd) for _ in range(3))
    rh4, rw4 = jsa.project_rel_tables_hl(
        jnp.asarray(q4), jnp.asarray(_randn(rng, 2 * gh - 1, hd, scale=0.2)),
        jnp.asarray(_randn(rng, 2 * gw - 1, hd, scale=0.2)), gh, gw)
    arrays = (q4, k4, v4, np.asarray(rh4), np.asarray(rw4))
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.array(a)) for a in arrays])


# ---------------------------------------------------------------------------
# entries against their JAX functions
# ---------------------------------------------------------------------------
GLOBAL_SHAPES = [(2, 4, 6, 64), (1, 8, 8, 80)]     # a rect grid; hd 64, 80


@pytest.mark.parametrize("bh,gh,gw,d", GLOBAL_SHAPES)
@pytest.mark.parametrize("glb", ["v1", "v2"])
def test_global_switch_matches_pallas(monkeypatch, glb, bh, gh, gw, d):
    """sam_global_attention under LAMENESS_GLB_KERNEL=v1 (K4) and v2 (K5)
    on both sides."""
    _set(monkeypatch, glb=glb)
    j, t = _global(1, bh, gh, gw, d)
    want = jsa.sam_global_attention(*j, interpret=True)
    _close(tsa.sam_global_attention(*t), want)


@pytest.mark.parametrize("bh,gh,gw,d", GLOBAL_SHAPES)
def test_global_v2_matches_pallas(bh, gh, gw, d):
    """K5 called by name; its operands are exact one-hot spreads."""
    j, t = _global(2, bh, gh, gw, d)
    want = jsa.sam_global_attention_v2(*j, interpret=True)
    _close(tsa.sam_global_attention_v2(*t), want)
    qa, ka, _ = tsa.global_v2_operands(t[0], t[1], t[3], t[4])
    assert qa.shape[-1] % 8 == 0 and qa.shape == ka.shape
    assert not qa[..., d + gh:].any() and not ka[..., d + gh:].any()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, ATOL),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("bh,gh,gw", [(2, 8, 8), (3, 5, 9)])
def test_global_v2_plain_is_k3_function(dtype, tol, bh, gh, gw):
    """K5's plain version (softmax over the augmented operands of the JAX
    entry) is K3's function, the fact that lets K5's kernel take K3's
    arguments: f32 at the parity gate, bf16 at the card tolerance (both
    round p to bf16 before PV, at other sum orders)."""
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(_randn(rng, bh, gh * gw, 64)).to(dtype)
               for _ in range(3))
    rh, rw = tsa.project_rel_tables(
        q, torch.from_numpy(_randn(rng, 2 * gh - 1, 64, scale=0.2)).to(dtype),
        torch.from_numpy(_randn(rng, 2 * gw - 1, 64, scale=0.2)).to(dtype),
        gh, gw)
    got = tsa.sam_global_attention_v2(q, k, v, rh, rw)
    want = tsa.sam_attention_reference(q, k, v, rh, rw)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("fused,grid_major", [(False, False), (True, True)])
def test_global_v2_args(fused, grid_major):
    """The C arguments of K5 and of K3 and K4, one routine
    (``global_args``): q, k, v, out at {head, 0, token} element strides, and
    the (BH, GH, GW, ·) tables at {head, grid row, grid column} where they
    lie, copied nowhere: contiguous, or grid-row-major as a batched einsum
    over the grid rows leaves them."""
    bh, gh, gw, d = 3, 4, 5, 64
    n = gh * gw
    if fused:
        q, k, v = torch.zeros(bh, n, 3, d).unbind(2)
    else:
        q, k, v = (torch.zeros(bh, n, d) for _ in range(3))
    if grid_major:
        rel_h, rel_w = (torch.zeros(gh, bh, gw, c).transpose(0, 1)
                        for c in (gh, gw))
    else:
        rel_h, rel_w = torch.zeros(bh, gh, gw, gh), torch.zeros(bh, gh, gw, gw)
    out = torch.empty(bh, n, d)
    args = tsa.global_args(q, k, v, rel_h, rel_w, out)
    assert args[:6] == tuple(t.data_ptr() for t in (q, k, v, rel_h, rel_w,
                                                   out))
    assert args[6:10] == (bh, n, d, gw) and args[11] == 0
    token = 3 * d if fused else d
    assert list(args[10]) == [n * token, 0, token] * 3 + [
        *rel_h.stride()[:3], *rel_w.stride()[:3], n * d, 0, d]
    # grid-row-major tables are no (BH, N, ·) view: token-contiguous ones are
    assert (rel_h.stride(1) == gw * rel_h.stride(2)) != grid_major


@pytest.mark.parametrize("fused", [True, False])
def test_global_hl_args(fused):
    """The C arguments of K6 (``global_hl_args``): q4, k4, v4, the
    head-last tables and the (B, N, nH·hd) output where they lie, at
    {image, head, token} element strides, with (outer, heads, tokens,
    head_dim, gw) = (B, nH, N, hd, GW): the unbind views of a fused qkv
    output as the engine passes them, or contiguous copies."""
    b, nh, gh, gw, hd = 2, 3, 4, 5, 64
    n = gh * gw
    if fused:
        q4, k4, v4 = torch.zeros(b, n, 3, nh, hd).unbind(2)
    else:
        q4, k4, v4 = (torch.zeros(b, n, nh, hd) for _ in range(3))
    rh4, rw4 = tsa.project_rel_tables_hl(
        q4, torch.zeros(2 * gh - 1, hd), torch.zeros(2 * gw - 1, hd), gh, gw)
    out = torch.empty(b, n, nh * hd)
    args = tsa.global_hl_args(q4, k4, v4, rh4, rw4, out)
    assert args[:6] == tuple(t.data_ptr() for t in (q4, k4, v4, rh4, rw4,
                                                   out))
    assert args[6:11] == (b, nh, n, hd, gw) and args[12] == 0
    token = (3 if fused else 1) * nh * hd

    def hl(t):
        return [t.stride(0), t.stride(2), t.stride(1)]
    assert list(args[11]) == [n * token, hd, token] * 3 + hl(rh4) + hl(
        rw4) + [n * nh * hd, hd, nh * hd]
    # the tables' token t lies at t·(token stride): evenly spaced, the
    # staging loop without a division per element (csrc/attention.cuh)
    for t, width in ((rh4, gh), (rw4, gw)):
        assert t.shape == (b, n, nh, width) and t.stride(-1) == 1
    if fused:
        assert k4.data_ptr() - q4.data_ptr() == nh * hd * 4


@pytest.mark.parametrize("kid,fused", [("K8", True), ("K8", False),
                                       ("K9", True), ("K9", False)])
def test_window_v2_v5_args(kid, fused):
    """The C arguments of K8 (``bias_args``, K7's) and K9 (``window_args``,
    K2's): q, k, v, the tables and the output where they lie, at
    {window, head, token} element strides, with (windows, heads, tokens,
    head_dim, win) = (BW, nH, N, hd, win).  K8 on the head-major views of a
    fused qkv output and the tables as the engine's head-major path
    reshapes them, K9 on the unbind slices and the head-last tables, or
    contiguous copies; K8 and K9 bind K7's and K2's argument list."""
    bw, nh, win, hd = 3, 2, 4, 64
    n = win * win
    if fused:
        q4, k4, v4 = torch.zeros(bw, n, 3, nh, hd).unbind(2)
    else:
        q4, k4, v4 = (torch.zeros(bw, n, nh, hd) for _ in range(3))
    token = (3 if fused else 1) * nh * hd
    tables = torch.zeros(2 * win - 1, hd), torch.zeros(2 * win - 1, hd)
    if kid == "K8":
        q, k, v = (t.transpose(1, 2) for t in (q4, k4, v4))
        rh, rw = (t.reshape(bw, nh, n, win) for t in tsa.project_rel_tables(
            q.reshape(bw * nh, n, hd), *tables, win))
        out = torch.empty(bw, nh, n, hd)
        args = tsa.bias_args(q, k, v, rh, rw, out)
        ptrs = (q, k, v, rh, rw, out)
        want = [n * token, hd, token] * 3 + [
            *rh.stride()[:3], *rw.stride()[:3], nh * n * hd, n * hd, hd]
        twin = tsa.WINDOW_V1_KERNEL
    else:
        rh, rw = tsa.project_rel_tables_hl(q4, *tables, win)
        out = torch.empty(bw, n, nh * hd)
        args = tsa.window_args(q4, k4, v4, rh, rw, out)
        ptrs = (q4, k4, v4, rh, rw, out)

        def hl(t):
            return [t.stride(0), t.stride(2), t.stride(1)]
        want = [n * token, hd, token] * 3 + hl(rh) + hl(rw) + [
            n * nh * hd, hd, nh * hd]
        twin = tsa.WINDOW_KERNEL
    assert args[:6] == tuple(t.data_ptr() for t in ptrs)
    assert args[6:11] == (bw, nh, n, hd, win) and args[12] == 0
    assert list(args[11]) == want
    kernel = tsa.WINDOW_V2_KERNEL if kid == "K8" else tsa.WINDOW_V5_KERNEL
    assert kernel.argtypes == twin.argtypes == tsa.WINDOW_KERNEL.argtypes
    # every operand's feature axis is contiguous: nothing is copied
    assert all(t.stride(-1) == 1 for t in ptrs)


@pytest.mark.parametrize("b,nh,gh,gw,hd", [(1, 2, 4, 6, 64),
                                           (2, 1, 6, 6, 80),
                                           (2, 3, 5, 7, 32)])
def test_global_v3_matches_pallas(b, nh, gh, gw, hd):
    """K6 on head-last layouts: the plain version on the augmented operands
    of the JAX entry."""
    j, t = _head_last(3, b, nh, gh, gw, hd)
    want = jsa.sam_global_attention_v3(*j, interpret=True)
    got = tsa.sam_global_attention_v3(*t)
    assert got.shape == (b, gh * gw, nh * hd)
    _close(got, want)


@pytest.mark.parametrize("bw,nh,win,hd", [(2, 2, 4, 64), (1, 1, 7, 80),
                                          (1, 2, 14, 32)])
@pytest.mark.parametrize("entry,win_kernel", [
    ("sam_window_attention", None),                 # K7
    ("sam_window_attention_v2", None),              # K8 by name
    ("sam_window_attention", "v2")])                # K8 by the switch
def test_head_major_windows_match_pallas(monkeypatch, entry, win_kernel, bw,
                                         nh, win, hd):
    _set(monkeypatch, win=win_kernel)
    j, t = _head_last(4, bw, nh, win, win, hd)
    j = [a.transpose(0, 2, 1, 3) for a in j]
    t = [a.transpose(1, 2) for a in t]           # head-major views
    want = getattr(jsa, entry)(*j, interpret=True)
    got = getattr(tsa, entry)(*t)
    assert got.shape == (bw, nh, win * win, hd)
    _close(got, want)


@pytest.mark.parametrize("bw,nh,win,hd", [(2, 2, 4, 64), (1, 1, 7, 80),
                                          (2, 2, 14, 16)])
def test_window_v5_matches_pallas(bw, nh, win, hd):
    """K9: head-last, the softmax denominator applied after PV."""
    j, t = _head_last(5, bw, nh, win, win, hd)
    want = jsa.sam_window_attention_v5(*j, interpret=True)
    got = tsa.sam_window_attention_v5(*t)
    assert got.shape == (bw, win * win, nh * hd)
    _close(got, want)


# ---------------------------------------------------------------------------
# VisionAttention under each switch value, against flax
# ---------------------------------------------------------------------------
def _attention_pair(dim, heads, table, seed):
    """Flax VisionAttention(fused=True) and the port's, same weights."""
    jm = jsam.VisionAttention(dim, heads, table, fused=True)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, *table, dim)))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        name = jax.tree_util.keystr(path)
        if name.endswith("['kernel']"):
            return z / np.sqrt(leaf.shape[0])
        return (0.1 if name.endswith("['bias']") else 0.2) * z
    params = jax.tree_util.tree_map_with_path(draw, shapes)
    tm = tsam.VisionAttention(dim, heads, table)
    tm.load_state_dict(from_jax_params({"m": params})["m"], strict=True)
    return jm, params, tm.eval()


@pytest.mark.parametrize("layer,switch", [
    ("window", None), ("window", "v3"), ("window", "v5"), ("window", "v1"),
    ("window", "v2"), ("window", "foo"),
    ("global", None), ("global", "v4"), ("global", "v1"), ("global", "v2"),
    ("global", "v3"), ("global", "foo")])
def test_vision_attention_matches_flax(monkeypatch, layer, switch):
    """A window layer (8x8 = its table) under each LAMENESS_WIN_KERNEL
    value; a global layer (an 18x20 grid on 20x20 tables) under each
    LAMENESS_GLB_KERNEL value."""
    if layer == "window":
        _set(monkeypatch, win=switch)
        table, grid = (8, 8), (8, 8)
    else:
        _set(monkeypatch, glb=switch)
        table, grid = (20, 20), (18, 20)
    jm, params, tm = _attention_pair(64, 2, table, seed=6)
    x = _randn(np.random.default_rng(7), 2, *grid, 64)
    want = jm.apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    _close(got, want)


# ---------------------------------------------------------------------------
# which kernel each case reaches
# ---------------------------------------------------------------------------
ENTRIES = {"K2": "sam_window_attention_v3", "K3": "sam_global_attention_v4",
           "K4": "sam_global_attention_v1", "K5": "sam_global_attention_v2",
           "K6": "sam_global_attention_v3", "K7": "sam_window_attention_v1",
           "K8": "sam_window_attention_v2", "K9": "sam_window_attention_v5"}


@pytest.mark.parametrize("win,glb,hd,grid,table,kernel", [
    # windows: H == W == the table side <= 16
    (None, None, 32, (8, 8), (8, 8), "K2"),
    ("v3", None, 32, (8, 8), (8, 8), "K2"),
    ("v5", None, 32, (8, 8), (8, 8), "K9"),
    ("v1", None, 32, (8, 8), (8, 8), "K7"),
    ("v2", None, 32, (8, 8), (8, 8), "K8"),
    ("foo", None, 32, (8, 8), (8, 8), "K7"),
    (None, "v1", 32, (8, 8), (8, 8), "K2"),       # GLB leaves windows alone
    ("v3", None, 64, (14, 14), (14, 14), "K2"),   # 64 + 28 <= 128
    ("v3", None, 112, (14, 14), (14, 14), "K7"),  # 112 + 28 > 128: v1
    ("v5", None, 112, (14, 14), (14, 14), "K7"),
    (None, None, 112, (14, 14), (14, 14), "K7"),
    ("v2", None, 112, (14, 14), (14, 14), "K8"),  # v2 needs no lanes
    # global: any other grid
    (None, None, 32, (18, 18), (18, 18), "K3"),
    (None, None, 32, (8, 8), (14, 14), "K3"),     # smaller than its table
    ("v2", None, 32, (18, 18), (18, 18), "K3"),   # WIN leaves globals alone
    (None, "v4", 32, (18, 18), (18, 18), "K3"),
    (None, "v1", 32, (18, 18), (18, 18), "K4"),
    (None, "v2", 32, (18, 18), (18, 18), "K5"),
    (None, "foo", 32, (18, 18), (18, 18), "K5"),
    (None, "v3", 32, (18, 18), (18, 18), "K6"),   # 32 + 18 <= 128
    (None, "v3", 80, (48, 2), (48, 2), "K6"),     # 80 + 48 == 128
    # hd + G > 128: the code of lameness_tpu/models/sam.py:162-186 takes
    # sam_global_attention, which reads "v3" and returns K5 (its comment
    # says the default v4 kernel)
    (None, "v3", 80, (49, 2), (49, 2), "K5"),
])
def test_dispatch_table(monkeypatch, win, glb, hd, grid, table, kernel):
    _set(monkeypatch, win=win, glb=glb)
    calls = []

    def spy(kid, fn):
        def wrapped(*args):
            calls.append(kid)
            return fn(*args)
        return wrapped
    for kid, name in ENTRIES.items():
        monkeypatch.setattr(tsa, name, spy(kid, getattr(tsa, name)))
    tm = tsam.VisionAttention(hd, 1, table)
    with torch.no_grad():
        out = tm(torch.randn(1, *grid, hd, generator=torch.Generator(
        ).manual_seed(0)))
    assert out.shape == (1, *grid, hd)
    assert calls == [kernel]
