"""The port's checkpoints (``lameness_tpu_torch/pipeline/checkpoint.py``) on
the CPU.

- ``save_params``/``load_params``: a state dict round trip through
  ``<name>/params.torch``, a name ``try_load_torch``'s globs do not take.
- The JAX package's pickle fallback (``<name>/params.pkl``, a nested numpy
  tree, written here with ``pickle`` as the JAX package writes it): read,
  converted by ``weights.from_jax_params`` and installed, the restored TCN
  giving the JAX module's outputs; a pickle holding anything but numpy
  trees is refused, an orbax directory reported and skipped.
- ``restore_engine``'s order (the port's own, then JAX's pickle, then the
  reference's torch files), its hits and misses, a broken checkpoint
  falling through to the next format, and trained pose into a pose engine.
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lameness_tpu.models.tcn import TCN as JTCN
from lameness_tpu_torch.models import yolo as tyolo
from lameness_tpu_torch.pipeline import checkpoint
from lameness_tpu_torch.pipeline.engine import make_test_engine
from lameness_tpu_torch.weights import (conv_tree_from_state_dict,
                                        from_jax_params, seeded_state_dict)


def _seeded(module, seed):
    return seeded_state_dict(module, torch.Generator().manual_seed(seed))


def _state_equal(module, sd):
    got = module.state_dict()
    return set(got) == set(sd) and all(torch.equal(got[k], sd[k].to(
        got[k].dtype)) for k in sd)


def test_save_load_round_trip(tmp_path):
    eng = make_test_engine(device="cpu")
    sd = eng.gait.state_dict()
    path = checkpoint.save_params(tmp_path, "gait", eng.gait)
    assert path == tmp_path / "gait" / "params.torch"
    assert sorted(p.name for p in path.parent.iterdir()) == ["params.torch"]
    back = checkpoint.load_params(tmp_path, "gait")
    assert set(back) == set(sd)
    for key, val in sd.items():
        assert torch.equal(back[key], val) and back[key].device.type == "cpu"
    # a mapping of tensors too; the reference-format globs do not see it
    checkpoint.save_params(tmp_path, "tcn", dict(eng.tcn.state_dict()))
    assert checkpoint.try_load_torch(tmp_path, "tcn") is None
    assert checkpoint.load_params(tmp_path, "missing") is None


def test_jax_pickle_tree_restores_tcn(tmp_path):
    """A JAX TCN's params pickled as the JAX package's fallback writes them
    install into the port's TCN, whose outputs then equal the JAX
    module's."""
    jtcn = JTCN(input_dim=44)
    tree = jax.tree_util.tree_map(np.asarray, jtcn.init(
        jax.random.PRNGKey(3), jnp.zeros((1, 125, 44))))
    (tmp_path / "tcn").mkdir()
    with open(tmp_path / "tcn" / "params.pkl", "wb") as f:
        pickle.dump(tree, f)
    eng = make_test_engine(device="cpu")
    loaded = checkpoint.restore_engine(eng, tmp_path)
    assert loaded == {"yolo": False, "dino": False, "tcn": True,
                      "gait": False}
    assert eng.loaded_weights["tcn"] and not eng.loaded_weights["gait"]
    assert _state_equal(eng.tcn, from_jax_params({"tcn": tree})["tcn"])
    x = np.random.default_rng(0).standard_normal((2, 125, 44)).astype(
        np.float32)
    want = np.asarray(jtcn.apply(tree, jnp.asarray(x)))
    with torch.no_grad():
        got = eng.tcn(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


class _NotATree:
    pass


def test_foreign_pickle_and_orbax_are_skipped(tmp_path, capsys):
    (tmp_path / "gait").mkdir()
    with open(tmp_path / "gait" / "params.pkl", "wb") as f:
        pickle.dump({"params": _NotATree()}, f)
    (tmp_path / "tcn" / "params").mkdir(parents=True)      # orbax layout
    assert checkpoint.load_jax_params(tmp_path, "gait") is None
    assert checkpoint.load_jax_params(tmp_path, "tcn") is None
    err = capsys.readouterr().err
    assert "not part of a numpy param tree" in err
    assert "orbax checkpoint" in err
    eng = make_test_engine(device="cpu")
    before = {k: v.clone() for k, v in eng.gait.state_dict().items()}
    loaded = checkpoint.restore_engine(eng, tmp_path)
    assert not loaded["gait"] and not loaded["tcn"]
    assert _state_equal(eng.gait, before)


def _write_three_yolos(root, model):
    """YOLO weights in all three formats, each from its own seed."""
    own, pkl, pt = (_seeded(model, s) for s in (1, 2, 3))
    checkpoint.save_params(root, "yolo", own)
    with open(root / "yolo" / "params.pkl", "wb") as f:
        pickle.dump(conv_tree_from_state_dict(pkl), f)
    torch.save({k: torch.as_tensor(v) for k, v in
                tyolo.export_ultralytics_state_dict(
                    conv_tree_from_state_dict(pt)).items()},
               root / "yolo" / "yolov8n.pt")
    return own, pkl, pt


def test_restore_engine_order(tmp_path):
    eng = make_test_engine(device="cpu")
    own, pkl, pt = _write_three_yolos(tmp_path, eng.yolo)
    for want, remove in ((own, "params.torch"), (pkl, "params.pkl"),
                         (pt, "yolov8n.pt")):
        eng = make_test_engine(device="cpu")
        loaded = checkpoint.restore_engine(eng, tmp_path)
        assert loaded == {"yolo": True, "dino": False, "tcn": False,
                          "gait": False}
        assert eng.loaded_weights["yolo"]
        assert _state_equal(eng.yolo, want)
        (tmp_path / "yolo" / remove).unlink()
    eng = make_test_engine(device="cpu")
    assert not checkpoint.restore_engine(eng, tmp_path)["yolo"]
    assert not eng.loaded_weights["yolo"]


def test_broken_own_checkpoint_falls_through(tmp_path, capsys):
    eng = make_test_engine(device="cpu")
    own, pkl, _ = _write_three_yolos(tmp_path, eng.yolo)
    checkpoint.save_params(tmp_path, "yolo", {"stem.conv.weight":
                                              torch.zeros(1)})
    loaded = checkpoint.restore_engine(eng, tmp_path)
    assert loaded["yolo"]
    assert "yolo checkpoint not installed (params.torch" in \
        capsys.readouterr().err
    assert _state_equal(eng.yolo, pkl)


def test_own_pose_checkpoint_into_pose_engine(tmp_path, capsys):
    import dataclasses
    pose = tyolo.YoloV8("n", num_classes=1, num_keypoints=20, device="cpu")
    sd = _seeded(pose, 7)
    checkpoint.save_params(tmp_path, "pose", sd)
    eng = make_test_engine(device="cpu")
    assert checkpoint.restore_engine(eng, tmp_path)["pose"]
    assert eng.loaded_weights["pose"] and _state_equal(eng.pose_model, sd)
    trimmed = make_test_engine(device="cpu")
    trimmed = trimmed.with_spec(dataclasses.replace(trimmed.spec,
                                                    pose_pixels=False))
    assert checkpoint.restore_engine(trimmed, tmp_path)["pose"] is False
    assert "pose_pixels=False" in capsys.readouterr().err
    with pytest.raises(ValueError, match="pose_pixels=False"):
        trimmed.install_state_dict("pose", sd)
