"""The engine's modes and the helpers nothing in the JAX package calls,
against the JAX package on the CPU.

The engines are tests/test_torch_engine.py's tiny pair (the same seeded
weights, carried by ``weights.from_jax_params``; the heads at dropout 0),
held to that file's gates (masks >= 99.5%, mask_iou_pred 1e-3, integers
equal, the rest 1e-4):

- ``process_clip_batch(mode="pair")`` against JAX's ``mode="pair"`` (JAX's
  monolith is ``slow`` on the CPU, tests/test_engine.py);
- the port's three modes bit for bit each other, with MC dropout on (the
  tiny engine's heads at 0.2 and 0.1), the generator advanced alike;
- ``warmup(mode=)`` returning JAX's keys, and ``fused_fn()``'s detection +
  heads core against JAX's on the same packed clip.

The helpers, each against its JAX function: the box conversions
(``ops/boxes.py``), ``nms_single``, ``crop_resize`` (linear and cubic, up
and down), ``crop_resize_normalize``, ``pad_to_square``, ``clip_views``,
``features_dict_from_device``, ``SamPromptEncoder.embed_points``,
``postprocess_mask``, and ``mc_dropout`` / ``predict_with_uncertainty`` at
dropout 0 (torch draws other masks than JAX).  A resize through
``F.interpolate`` is held within 1e-3 on [0, 1] data, as
tests/test_torch_models.py holds the letterbox; ``crop_resize`` computes
JAX's own weights, within 1e-5.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lameness_tpu.models import pose as jpose
from lameness_tpu.models import sam as jsam
from lameness_tpu.models import tcn as jtcn
from lameness_tpu.ops import boxes as jboxes
from lameness_tpu.ops import nms as jnms
from lameness_tpu.ops import preprocess as jprep
from lameness_tpu_torch.core.config import TcnConfig
from lameness_tpu_torch.models import pose as tpose
from lameness_tpu_torch.models import sam as tsam
from lameness_tpu_torch.models import tcn as ttcn
from lameness_tpu_torch.ops import boxes as tboxes
from lameness_tpu_torch.ops import nms as tnms
from lameness_tpu_torch.ops import preprocess as tprep
from lameness_tpu_torch.pipeline.engine import ENGINE_MODES, make_test_engine
from tests.test_torch_engine import (_assert_gates, _jax_engine, _leaves,
                                     _port_engine)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: small tensor ops, test workers sharing cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engines():
    jeng = _jax_engine()
    return jeng, _port_engine(jeng.params)


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(0).integers(0, 256, (2, 15, 90, 160, 3),
                                             dtype=np.uint8)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _equal_trees(a, b):
    a, b = dict(_leaves(a)), dict(_leaves(b))
    assert set(a) == set(b)
    for key in a:
        assert a[key].dtype == b[key].dtype, key
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def _close(got, want, atol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


# ---------------------------------------------------------------------------
# the modes
# ---------------------------------------------------------------------------
def test_pair_mode_matches_jax(engines, frames):
    jeng, teng = engines
    want = jeng.process_clip_batch(frames, mode="pair")
    _assert_gates(teng.process_clip_batch(frames, _gen(), mode="pair"), want)


def test_modes_are_one_computation():
    """With MC dropout on: pair and monolith equal staged bit for bit, host
    and device outputs, and leave the generator where staged leaves it;
    two calls in a row with one generator equal two staged calls."""
    eng = make_test_engine(device="cpu", with_sam=True)
    eng.config = dataclasses.replace(eng.config, tcn=TcnConfig(mc_samples=3))
    clips = np.random.default_rng(1).integers(0, 256, (2, 15, 90, 160, 3),
                                              dtype=np.uint8)
    g_ref = _gen(3)
    ref = [eng.process_clip_batch(clips, g_ref) for _ in range(2)]
    assert ref[0]["tcn_uncertainty"].min() > 0
    dev = eng.to_device(clips)
    staged_dev = eng.run_staged(dev, _gen(3))
    for mode in ENGINE_MODES:
        g = _gen(3)
        for want in ref:
            _equal_trees(eng.process_clip_batch(clips, g, mode=mode), want)
        assert torch.equal(g.get_state(), g_ref.get_state()), mode
        out = eng.process_clip_batch(dev, _gen(3), mode=mode, readback=False)
        assert all(isinstance(v, torch.Tensor) for _, v in
                   _leaves_t(out)), mode
        _equal_trees(_numpy(out), _numpy(staged_dev))
    _equal_trees(_numpy(eng.run_paired(dev, _gen(3))), _numpy(staged_dev))
    with pytest.raises(ValueError, match="mode"):
        eng.process_clip_batch(clips, _gen(), mode="fused")


def _leaves_t(tree, prefix=""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves_t(val, f"{prefix}{key}.")
        else:
            yield prefix + key, val


def _numpy(tree):
    return {k: v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy()
            for k, v in _leaves_t(tree)}


@pytest.mark.parametrize("mode", ["staged", "pair", "monolith"])
def test_warmup_returns_jax_keys(engines, mode):
    """The JAX package's warmup keys (monolith warms the four stage
    programs as staged does), at the batch the other tests compiled."""
    jeng, teng = engines
    got = teng.warmup(batch=2, mode=mode)
    if mode == "monolith":
        assert set(got) == {"detect", "sam", "dino", "heads"}
    else:
        assert set(got) == set(jeng.warmup(batch=2, mode=mode))
    assert all(v >= 0 for v in got.values())


def test_fused_fn_core_matches_jax(engines):
    """fused_fn's example: a (1, n_packed, H, W, 3) uint8 zero clip and a
    generator; its detection + heads core against JAX's (jitted) on a
    seeded packed clip."""
    jeng, teng = engines
    jcore, (jparams, jframes, jrng) = jeng.fused_fn()
    core, (tframes, gen) = teng.fused_fn()
    assert tuple(tframes.shape) == tuple(jframes.shape)
    assert tframes.dtype == torch.uint8 and not tframes.any()
    assert isinstance(gen, torch.Generator)
    clip = np.random.default_rng(2).integers(0, 256, jframes.shape,
                                             dtype=np.uint8)
    want = jax.jit(jcore)(jparams, jnp.asarray(clip), jrng)
    got = core(torch.from_numpy(clip), gen)
    _assert_gates(_numpy(got), {k: np.asarray(v) for k, v in
                                _leaves_t(want)})


# ---------------------------------------------------------------------------
# helpers nothing in the JAX package calls
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["xywh_to_xyxy", "xyxy_to_xywh",
                                  "xyxy_to_zsr", "zsr_to_xyxy"])
def test_box_conversions_match_jax(name):
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 50, (2, 10, 4)).astype(np.float32)
    x[..., 2:] = x[..., :2] + 1 + np.abs(x[..., 2:])
    x[0, 0, 3] = x[0, 0, 1]              # a zero height (zsr's clamp)
    want = getattr(jboxes, name)(jnp.asarray(x))
    got = getattr(tboxes, name)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-5)


@pytest.mark.parametrize("agnostic,threshold", [(False, 0.0), (True, 0.3)])
def test_nms_single_matches_jax(agnostic, threshold):
    rng = np.random.default_rng(4)
    centre = rng.uniform(20, 80, (40, 2))
    size = rng.uniform(10, 30, (40, 2))
    boxes = np.concatenate([centre - size / 2, centre + size / 2],
                           -1).astype(np.float32)
    scores = rng.uniform(0, 1, 40).astype(np.float32)
    classes = rng.integers(0, 3, 40).astype(np.int32)
    want = jnms.nms_single(jnp.asarray(boxes), jnp.asarray(scores),
                           jnp.asarray(classes), 8, 0.45, threshold,
                           agnostic)
    got = tnms.nms_single(torch.from_numpy(boxes), torch.from_numpy(scores),
                          torch.from_numpy(classes), 8, 0.45, threshold,
                          agnostic)
    assert np.asarray(want[3]).sum() >= 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("box,out_hw,method", [
    ([10.0, 5.0, 26.0, 21.0], (24, 24), "linear"),      # up: no antialias
    ([10.0, 5.0, 58.0, 53.0], (24, 24), "linear"),      # down: antialiased
    ([3.3, 7.9, 71.2, 40.4], (20, 36), "linear"),       # fractional box
    ([-6.0, 10.0, 40.0, 70.0], (16, 16), "linear"),     # past the frame
    ([10.0, 5.0, 58.0, 53.0], (24, 24), "cubic"),
    ([10.0, 5.0, 26.0, 21.0], (24, 24), "cubic")])
def test_crop_resize_matches_jax(box, out_hw, method):
    img = np.random.default_rng(5).integers(0, 256, (64, 80, 3),
                                            dtype=np.uint8)
    want = jprep.crop_resize(jnp.asarray(img), jnp.asarray(box), out_hw,
                             method=method)
    got = tprep.crop_resize(torch.from_numpy(img), torch.tensor(box),
                            out_hw, method=method)
    _close(got, want, 1e-5)
    # a batch of frames and boxes: each as alone
    batch = tprep.crop_resize(torch.from_numpy(np.stack([img, img[::-1]])),
                              torch.tensor([box, box]), out_hw, method)
    assert torch.equal(batch[0], got)


def test_crop_resize_normalize_matches_jax():
    img = np.random.default_rng(6).integers(0, 256, (64, 80, 3),
                                            dtype=np.uint8)
    box = [4.5, 2.0, 70.0, 60.0]
    want = jprep.crop_resize_normalize(jnp.asarray(img), jnp.asarray(box),
                                       (28, 28))
    got = tprep.crop_resize_normalize(torch.from_numpy(img),
                                      torch.tensor(box), (28, 28))
    _close(got, want, 1e-4)
    half = tprep.crop_resize_normalize(torch.from_numpy(img),
                                       torch.tensor(box), (28, 28),
                                       dtype=torch.bfloat16)
    assert half.dtype == torch.bfloat16 and half.shape == got.shape


def test_pad_to_square_matches_jax():
    img = np.random.default_rng(7).integers(0, 256, (90, 160, 3),
                                            dtype=np.uint8)
    want, wr = jprep.pad_to_square(jnp.asarray(img), 128)
    got, gr = tprep.pad_to_square(torch.from_numpy(img[None]), 128)
    assert gr == pytest.approx(float(wr))
    _close(got[0], want, 1e-3)


@pytest.mark.parametrize("boxes", [False, True])
def test_clip_views_match_jax(boxes):
    rng = np.random.default_rng(8)
    clip = rng.integers(0, 256, (5, 72, 128, 3), dtype=np.uint8)
    prim = None
    if boxes:
        xy = rng.uniform(0, 40, (5, 2))
        prim = np.concatenate([xy, xy + rng.uniform(20, 60, (5, 2))],
                              -1).astype(np.float32)
    wy, wd = jprep.clip_views(jnp.asarray(clip),
                              None if prim is None else jnp.asarray(prim),
                              yolo_size=64, dino_size=32)
    gy, gd = tprep.clip_views(torch.from_numpy(clip),
                              None if prim is None else torch.from_numpy(
                                  prim), yolo_size=64, dino_size=32)
    _close(gy, wy, 1e-3)
    _close(gd, wd, 1e-4)


def test_features_dict_from_device_matches_jax():
    """One clip's device features, each flag on and off, through both
    functions: the same keys in the same order, the same floats."""
    rng = np.random.default_rng(9)
    xy = rng.uniform(100, 400, (25, 20, 2)).astype(np.float32)
    conf = rng.uniform(0.2, 1.0, (25, 20)).astype(np.float32)
    dev = tpose.locomotion_features_device(
        torch.from_numpy(xy), torch.from_numpy(conf),
        torch.ones(25, dtype=torch.bool))
    base = {k: v.numpy() for k, v in dev.items()}
    flags = [k for k in base if k.endswith("_ok")]
    assert all(base[k] for k in flags)
    cases = [base] + [{**base, k: np.asarray(False)} for k in flags] \
        + [{**base, **{k: np.asarray(False) for k in flags}}]
    for case in cases:
        want = jpose.features_dict_from_device(case)
        got = tpose.features_dict_from_device(
            {k: torch.from_numpy(np.asarray(v)) for k, v in case.items()})
        assert list(got) == list(want)
        assert got == want


def test_embed_points_matches_jax(engines):
    jeng, teng = engines
    rng = np.random.default_rng(10)
    points = rng.uniform(0, 128, (2, 5, 2)).astype(np.float32)
    labels = rng.integers(-1, 2, (2, 5)).astype(np.int32)
    labels[0, :3] = [-1, 0, 1]
    want = jeng.sam.apply(jeng.params["sam"], jnp.asarray(points),
                          jnp.asarray(labels),
                          method=lambda m, p, lab:
                          m.prompt_encoder.embed_points(p, lab))
    with torch.no_grad():
        got = teng.sam.prompt_encoder.embed_points(
            torch.from_numpy(points), torch.from_numpy(labels))
    _close(got, want, 1e-5)


def test_postprocess_mask_matches_jax():
    """A smooth logit field with a zero crossing: the same mask but for
    pixels whose value rounds across 0 (the resize sums in another
    order); and the JAX test's geometry."""
    yy, xx = np.mgrid[0:64, 0:64]
    low = (np.sin(yy / 6.0) * 4 + np.cos(xx / 9.0) * 3 - 1).astype(
        np.float32)
    want = np.asarray(jsam.postprocess_mask(jnp.asarray(low), 128 / 160,
                                            (90, 160), img_size=128))
    got = tsam.postprocess_mask(torch.from_numpy(low), 128 / 160, (90, 160),
                                img_size=128).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype == bool
    assert (got == want).mean() >= 0.999
    geo = np.full((256, 256), -5.0, np.float32)
    geo[:64] = 5.0
    m = tsam.postprocess_mask(torch.from_numpy(geo), 1024 / 400, (200, 400))
    w = jsam.postprocess_mask(jnp.asarray(geo), 1024 / 400, (200, 400))
    assert (m.numpy() == np.asarray(w)).mean() >= 0.999
    assert bool(m[10, 10]) and not bool(m[150, 10])


def test_mc_helpers_match_jax(engines):
    """At dropout 0 (torch draws other masks than JAX): the mean is the
    deterministic forward, the std 0, as JAX's; at dropout 0.2 the port's
    samples are one batched forward of the replicated batch, the engine's
    heads' layout, with std at ddof 1."""
    jeng, teng = engines
    x = np.random.default_rng(11).standard_normal((3, 125, 44)).astype(
        np.float32)
    params = jeng.params["tcn"]
    wm, ws = jtcn.predict_with_uncertainty(jeng.tcn, params, jnp.asarray(x),
                                           jax.random.PRNGKey(0), 4)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        gm, gs = ttcn.predict_with_uncertainty(teng.tcn, xt, _gen(), 4)
        fm, fs = ttcn.mc_dropout(
            lambda xs, generator: teng.tcn(xs, generator=generator), xt,
            _gen(), 4)
    vm, vs = jtcn.mc_dropout(
        lambda k: jeng.tcn.apply(params, jnp.asarray(x), deterministic=False,
                                 rngs={"dropout": k}),
        jax.random.PRNGKey(0), 4)
    for (m, s), (jm, js) in (((gm, gs), (wm, ws)), ((fm, fs), (vm, vs))):
        _close(m, jm, 1e-5)
        _close(s, js, 1e-6)
    mc = ttcn.TCN(input_dim=44, dropout=0.2, device="cpu")
    mc.load_state_dict(teng.tcn.state_dict())
    with torch.no_grad():
        m, s = ttcn.predict_with_uncertainty(mc, xt, _gen(5), 6)
        rows = mc(xt.repeat(6, 1, 1), generator=_gen(5)).view(6, 3, 1)
    assert torch.equal(m, rows.mean(0)) and torch.equal(s, rows.std(0))
    assert (s > 0).all()
