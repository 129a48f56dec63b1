"""The port's SAM modes against the JAX engine, on the CPU: the pad-free
rect canvas (``sam_rect``) and chunked encoding (``sam_encode_chunk``).

SAM stages run on the same packed frames and boxes with the same seeded
weights (``tests/test_torch_engine.py``'s ``_seeded``, carried over by
``weights.from_jax_params``).  The JAX rect engine runs its einsum path
(its Pallas global kernel needs an even grid height, and the rect grids
here are 5 and 11 rows, as in tests/test_sam_rect.py's engine); the
chunked one its fused kernels in interpret mode, as tests/test_sam_chunk.py
does.  Gates, those of tests/test_torch_engine.py: masks on
>= 99.5% of pixels, ``mask_iou_pred`` within 1e-3, the rest within 1e-4.
Chunked against unchunked within the port, those of
tests/test_sam_chunk.py: mask bits equal, ``mask_iou_pred`` within 1e-5.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lameness_tpu.core.config import Config as JConfig
from lameness_tpu.models.sam import Sam as JSam
from lameness_tpu.pipeline import engine as jengine
from lameness_tpu_torch.core.config import Config, SamConfig
from lameness_tpu_torch.models.sam import Sam
from lameness_tpu_torch.pipeline.engine import EngineSpec, LamenessEngine
from lameness_tpu_torch.weights import from_jax_params
from tests.test_torch_engine import _assert_gates, _seeded


def _sam_engines(frame_hw, sam_size, fused, **spec_kw):
    """A JAX and a port engine holding only a tiny SAM (dim 64, depth 2, 4
    heads, global layer 1) at ``sam_size``, same seeded weights, over
    4-frame clips (every frame a det frame).  ``fused`` is the JAX SAM's
    ``fused_global``: True runs its Pallas kernels (interpret mode) and
    encodes the batch at once, chunked if asked; None its einsum path,
    frame by frame."""
    kw = dict(clip_frames=4, fps=2, frame_height=frame_hw[0],
              frame_width=frame_hw[1], yolo_size=64, pose_size=64,
              dino_size=56, sam_size=sam_size, sam_mask_size=32, **spec_kw)
    geo = dict(img_size=sam_size, encoder_dim=64, encoder_depth=2,
               encoder_heads=4, global_attn_indexes=(1,))
    jeng = jengine.LamenessEngine(config=JConfig(),
                                  spec=jengine.EngineSpec(**kw),
                                  init_models=False)
    jeng.sam = JSam(fused_global=fused, **geo)
    jeng.params = {"sam": _seeded(
        jeng.sam, jnp.zeros((1, sam_size, sam_size, 3)), jnp.zeros((1, 4)),
        seed=3)}
    jeng.yolo = jeng.dino = jeng.tcn = jeng.gait = None
    jeng.pose_model = None
    jeng.loaded_weights = {}
    jeng._build_jits()
    teng = LamenessEngine(spec=EngineSpec(**kw), device="cpu",
                          init_models=False)
    teng.sam = Sam(device="cpu", **geo)
    teng.load_state_dicts(from_jax_params(jeng.params))
    return jeng, teng


def _inputs(h, w, batch=1):
    rng = np.random.default_rng(11)
    frames = rng.integers(0, 256, (batch, 4, h, w, 3), dtype=np.uint8)
    boxes = np.array([0.1 * w, 0.15 * h, 0.75 * w, 0.9 * h], np.float32)
    boxes = boxes + rng.uniform(-3, 3, (batch, 4, 4)).astype(np.float32)
    return frames, boxes


def _port_sam(teng, frames, boxes):
    with torch.no_grad():
        out = teng._sam_stage(torch.from_numpy(frames),
                              torch.from_numpy(boxes))
    return {k: v.numpy() for k, v in out.items()}


def _spy_encode(monkeypatch, teng):
    """Record (input shape, content rows) of each encoder call."""
    calls = []
    encode = teng.sam.encode

    def spy(images, content_rows=0):
        calls.append((tuple(images.shape), content_rows))
        return encode(images, content_rows)
    monkeypatch.setattr(teng.sam, "encode", spy)
    return calls


@pytest.mark.parametrize("frame_hw,sam_size,canvas", [
    ((90, 160), 128, (80, 128)),       # token grid (5, 8)
    ((180, 320), 288, (176, 288)),     # (11, 18): a global grid past 16
])
def test_rect_sam_matches_jax(monkeypatch, frame_hw, sam_size, canvas):
    """The rect canvas (content rounded up to 16 px, no pad rows, no
    pad-row split) against the JAX rect engine."""
    monkeypatch.delenv("LAMENESS_SAM_PADSPLIT", raising=False)
    jeng, teng = _sam_engines(frame_hw, sam_size, None, sam_rect=True)
    calls = _spy_encode(monkeypatch, teng)
    frames, boxes = _inputs(*frame_hw)
    want = jeng._jit_sam(jeng.params, jnp.asarray(frames),
                         jnp.asarray(boxes))
    got = _port_sam(teng, frames, boxes)
    assert calls == [((4,) + canvas + (3,), 0)]
    assert got["masks"].shape == (1, 4, 32, 32)
    _assert_gates(got, {k: np.asarray(v) for k, v in want.items()})
    assert 0.0 < got["mask_area_frac"].mean() < 1.0


@pytest.fixture(scope="module")
def chunk_engines():
    return _sam_engines((64, 96), 128, True)


@pytest.fixture(scope="module")
def chunk_inputs():
    return _inputs(64, 96, batch=2)


@pytest.mark.parametrize("chunk", [1, 2, 3])
def test_chunked_encode_matches_one_call(monkeypatch, chunk_engines,
                                         chunk_inputs, chunk):
    """Sub-batches of 1, 2 and 3 of the 8 frames (3 leaves a short tail,
    each chunk recomputes the pad rows): the one call's mask bits, its
    mask_iou_pred within 1e-5."""
    teng = chunk_engines[1]
    full = _port_sam(teng, *chunk_inputs)
    eng = teng.with_spec(dataclasses.replace(teng.spec,
                                             sam_encode_chunk=chunk))
    calls = _spy_encode(monkeypatch, eng)
    out = _port_sam(eng, *chunk_inputs)
    sizes = [shape[0] for shape, _ in calls]
    assert sizes == [chunk] * (8 // chunk) + ([8 % chunk] if 8 % chunk
                                              else [])
    assert {rows for _, rows in calls} == {6}        # 85 of 128 px: 6 rows
    np.testing.assert_array_equal(out["masks"], full["masks"])
    np.testing.assert_allclose(out["mask_iou_pred"], full["mask_iou_pred"],
                               atol=1e-5, rtol=0)


def test_chunked_encode_matches_jax(chunk_engines, chunk_inputs):
    """Chunks of 3 on both sides (JAX pads the tail chunk, the port runs
    it short)."""
    jeng, teng = chunk_engines
    jchunk = jeng.with_spec(dataclasses.replace(jeng.spec,
                                                sam_encode_chunk=3))
    frames, boxes = chunk_inputs
    want = jchunk._jit_sam(jchunk.params, jnp.asarray(frames),
                           jnp.asarray(boxes))
    tchunk = teng.with_spec(dataclasses.replace(teng.spec,
                                                sam_encode_chunk=3))
    got = _port_sam(tchunk, frames, boxes)
    _assert_gates(got, {k: np.asarray(v) for k, v in want.items()})


def test_config_knob_reaches_spec():
    """config.sam.encode_chunk flows onto the spec, also for an engine
    whose models the caller installs; a spec's own value wins."""
    cfg = Config(sam=SamConfig(encode_chunk=4))
    eng = LamenessEngine(config=cfg, spec=EngineSpec(use_sam_model=False),
                         device="cpu", init_models=False)
    assert eng.spec.sam_encode_chunk == 4
    assert eng.with_spec(EngineSpec()).spec.sam_encode_chunk == 4
    eng = LamenessEngine(config=cfg, spec=EngineSpec(sam_encode_chunk=2),
                         device="cpu", init_models=False)
    assert eng.spec.sam_encode_chunk == 2
