"""Trained pose in the port against the JAX package, on the CPU.

- the pose tables and ``map_roboflow_to_old_device``;
- YOLOv8-n with the 20-keypoint head: per-level maps, the keypoint decode
  and ``detect``'s recovery of the selected anchors' keypoints;
- the tiny engine (tests/test_torch_engine.py) with the same seeded pose
  params installed in both engines (JAX through ``install_pose_params``),
  under full and split ingest.  Gates: ``_assert_gates``'s (which hold
  ``pose_trained_mask`` equal and ``keypoints_model`` within 1e-4), on a
  batch that holds hits and misses;
- the refusals under ``pose_pixels=False``.

The pose params are ``_seeded``'s with every kernel times
``chip_smoke.POSE_GAIN``: at the lecun draw alone the pose head hardly
reads the frame (its keypoints move by about 1e-4 px between frames), and
the locomotion ratios of such strides turn float rounding into percent (the
engines then agree on the keypoints within 1.5e-5 and differ by 3% in
``front_leg_asymmetry``).  ``chip_smoke.calibrate_pose_tree`` then sets the
class head so that about half of the pose frames hit, as the card's run
does.  The frames are seeded 5x5-pixel blocks, so the 64² letterbox does
not average them to grey.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lameness_tpu.models import pose as jpose
from lameness_tpu.models import yolo as jyolo
from lameness_tpu_torch.models import pose as tpose
from lameness_tpu_torch.models import yolo as tyolo
from lameness_tpu_torch.weights import from_jax_params
from chip_smoke import POSE_GAIN, calibrate_pose_tree
from tests.test_torch_engine import (_assert_gates, _jax_engine,
                                     _port_engine, _seeded)

SPLIT = dict(lo_height=45, lo_width=80)


def _pose_params(cls_bias: float = 0.0):
    """Seeded flax params of YOLOv8-n with the 20-keypoint head (numpy),
    kernels times POSE_GAIN, ``cls_bias`` added to every level's cls2."""
    model = jyolo.YoloV8(variant="n", num_classes=1,
                         num_keypoints=jpose.NUM_KEYPOINTS)
    tree = _seeded(model, jnp.zeros((1, 64, 64, 3)), seed=6)

    def scale(path, leaf):
        leaf = np.asarray(leaf)
        if jax.tree_util.keystr(path).endswith("['kernel']"):
            return leaf * POSE_GAIN
        return leaf
    tree = jax.tree_util.tree_map_with_path(scale, tree)
    for i in range(3):
        tree["params"][f"detect{i}"]["cls2"]["bias"] += cls_bias
    return model, tree


def _frames():
    blocks = np.random.default_rng(0).integers(0, 256, (2, 15, 18, 32, 3),
                                               dtype=np.uint8)
    return blocks.repeat(5, axis=2).repeat(5, axis=3)


@pytest.fixture(scope="module")
def engines():
    jeng = _jax_engine()
    return jeng, _port_engine(jeng.params)


def _install(jeng, teng, frames):
    """The same calibrated pose params into both engines (calibrated on the
    port's frames on the device); returns the tree."""
    _, tree = _pose_params()
    tree, _, margin = calibrate_pose_tree(teng, tree, teng.to_device(frames))
    assert margin > 1e-3, margin
    jeng.install_pose_params(tree)
    return tree


def test_pose_tables_match_jax():
    assert tpose.KEYPOINT_NAMES == jpose.KEYPOINT_NAMES
    assert tpose.NUM_KEYPOINTS == jpose.NUM_KEYPOINTS == 20
    assert tpose.ROBOFLOW_TO_OLD == jpose.ROBOFLOW_TO_OLD
    assert tpose.H_NAMES == jpose.H_NAMES
    np.testing.assert_array_equal(tpose._R2O_SRC, jpose._R2O_SRC)
    np.testing.assert_array_equal(tpose._R2O_OK, jpose._R2O_OK)


def test_map_roboflow_to_old_matches_jax():
    kp = np.random.default_rng(1).standard_normal((3, 4, 20, 3)
                                                  ).astype(np.float32)
    want = np.asarray(jpose.map_roboflow_to_old_device(jnp.asarray(kp)))
    got = tpose.map_roboflow_to_old_device(torch.from_numpy(kp)).numpy()
    np.testing.assert_array_equal(got, want)


def test_pose_model_and_detect_match_jax():
    """Per-level maps (with "kpt"), the decode and detect's keypoints."""
    model, tree = _pose_params(cls_bias=0.5)
    tmodel = tyolo.YoloV8("n", num_classes=1,
                          num_keypoints=tpose.NUM_KEYPOINTS, device="cpu")
    tmodel.load_state_dict(from_jax_params({"pose": tree})["pose"])
    x = np.random.default_rng(2).random((3, 64, 64, 3), dtype=np.float32)
    jl = model.apply(tree, jnp.asarray(x))["levels"]
    with torch.no_grad():
        tl = tmodel(torch.from_numpy(x))["levels"]
    for a, b in zip(tl, jl):
        assert set(a) == set(b) == {"box", "cls", "kpt"}
        for key in a:
            np.testing.assert_allclose(a[key].numpy(), np.asarray(b[key]),
                                       atol=1e-4, rtol=0, err_msg=key)
    _, _, jk = jyolo.decode_predictions(jl)
    _, _, tk = tyolo.decode_predictions(tl)
    assert tk.shape == jk.shape == (3, 84, 20, 3)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-4,
                               rtol=0)
    jd = jyolo.detect(jl, conf_threshold=0.5, max_det=4)
    td = tyolo.detect(tl, conf_threshold=0.5, max_det=4)
    valid = np.asarray(jd["valid"])
    assert valid.any() and (td["valid"].numpy() == valid).all()
    np.testing.assert_allclose(td["keypoints"].numpy()[valid],
                               np.asarray(jd["keypoints"])[valid],
                               atol=1e-4, rtol=0)


def _check_trained(got, want):
    _assert_gates(got, want)
    hit = np.asarray(want["pose_trained_mask"])
    assert hit.any() and not hit.all(), \
        f"the batch must hold hits and misses: {int(hit.sum())}/{hit.size}"
    np.testing.assert_array_equal(np.asarray(got["keypoints_model"])[~hit],
                                  0.0)


@pytest.mark.parametrize("split", [False, True])
def test_trained_pose_engine_matches_jax(engines, split):
    jeng, teng = engines
    kw = SPLIT if split else {}
    jm = jeng.with_spec(dataclasses.replace(jeng.spec, **kw))
    tm = teng.with_spec(dataclasses.replace(teng.spec, **kw))
    frames = _frames()
    if split:
        frames = jm.spec.split_pack_host(frames)
    _install(jm, tm, frames)
    want = jm.process_clip_batch(frames)
    got = tm.process_clip_batch(frames,
                                generator=torch.Generator().manual_seed(0))
    assert {"keypoints_model", "pose_trained_mask"} <= set(got)
    assert got["keypoints_model"].shape == (2, 15, 20, 3)
    _check_trained(got, want)


def test_trained_pose_run_staged_keys(engines):
    """The device tree of run_staged carries the two trained-pose leaves
    beside the heuristic default's, and the heads stage without frames
    refuses instead of falling back to the heuristic."""
    jeng, teng = engines
    tm = teng.with_spec(dataclasses.replace(teng.spec))
    _install(jeng.with_spec(dataclasses.replace(jeng.spec)), tm, _frames())
    frames = torch.from_numpy(tm.spec.pack_frames(_frames()))
    out = tm.run_staged(frames)
    assert out["pose_trained_mask"].dtype == torch.bool
    assert out["keypoints_model"].dtype == torch.float32
    with pytest.raises(ValueError, match="frames"):
        tm._heads_stage(out["primary_boxes"], out["primary_scores"],
                        torch.Generator().manual_seed(0))


def test_install_pose_params_refuses_without_pose_pixels(engines):
    eng = _port_engine({k: v for k, v in engines[0].params.items()
                        if k != "pose"})
    trimmed = eng.with_spec(dataclasses.replace(eng.spec, pose_pixels=False))
    _, tree = _pose_params()
    with pytest.raises(ValueError, match="pose_pixels"):
        trimmed.install_pose_params(tree)
    assert not eng.loaded_weights["pose"] and eng.pose_model is None
    eng.install_pose_params(tree)
    assert eng.loaded_weights["pose"]
    with pytest.raises(ValueError, match="pose_pixels"):
        eng.with_spec(dataclasses.replace(eng.spec, pose_pixels=False))
    shared = eng.with_spec(dataclasses.replace(eng.spec))
    assert shared.pose_model is eng.pose_model
    assert shared.loaded_weights is eng.loaded_weights


def test_load_torch_weights_pose_matches_install(engines):
    """The ultralytics file layout of the same params, through
    load_torch_weights("pose"), installs the same state dict."""
    jeng, teng = engines
    _, tree = _pose_params(cls_bias=0.5)
    sd = {k: torch.as_tensor(v) for k, v in
          jyolo.export_ultralytics_state_dict(tree, has_pose=True).items()}
    a, b = (e.with_spec(dataclasses.replace(e.spec)) for e in (teng, teng))
    a.install_pose_params(tree)
    b.load_torch_weights("pose", sd)
    assert a.loaded_weights["pose"] and b.loaded_weights["pose"]
    want = a.pose_model.state_dict()
    got = b.pose_model.state_dict()
    assert list(got) == list(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key
