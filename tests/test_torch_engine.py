"""The port's clip engine against the JAX engine, end to end on the CPU.

Both run the ``make_test_engine`` geometry (15 frames at 160x90, 64² YOLO,
a 64-wide 2-layer DINO) plus the tiny fused SAM of
tests/test_sam_batched_stage.py (128² canvas, dim 64, depth 2, 4 heads,
global layer 1), with TCN and GaitTransformer built with dropout 0 so the
MC-dropout heads are deterministic.  Weights are drawn with numpy from a
seed and carried to the port by ``weights.from_jax_params``; the frames are
the same seeded uint8 clips.  Gates: detections and primaries 1e-4; masks
agree on >= 99.5% of pixels and mask_iou_pred within 1e-3 (the JAX
package's own fused-vs-serial gates); embeddings and heads 1e-4.
"""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from lameness_tpu.core.config import Config as JConfig
from lameness_tpu.models import dino as jdino
from lameness_tpu.models.gait_transformer import GaitTransformer as JGait
from lameness_tpu.models.sam import Sam as JSam
from lameness_tpu.models.tcn import TCN as JTCN
from lameness_tpu.models.yolo import YoloV8 as JYolo
from lameness_tpu.pipeline import engine as jengine
from lameness_tpu_torch.core.config import Config, TcnConfig
from lameness_tpu_torch.models.gait_transformer import GaitTransformer
from lameness_tpu_torch.models.tcn import TCN
from lameness_tpu_torch.pipeline.engine import EngineSpec, make_test_engine
from lameness_tpu_torch.weights import from_jax_params


def _seeded(module, *args, seed):
    """Seeded numpy params at the shapes the flax init would give."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        if name.endswith("['var']"):
            return 1.0 + 0.2 * np.abs(z)
        if name.endswith(("['scale']", "['g']")):
            return 1.0 + 0.1 * z
        if name.endswith(("['bias']", "['b']", "['mean']")):
            return 0.1 * z
        if name.endswith(("['kernel']", "['v']")):
            return z / np.sqrt(np.prod(leaf.shape[:-1]))
        if "upscale_conv" in name and len(leaf.shape) == 4:
            return z / np.sqrt(leaf.shape[0])
        if "rel_pos" in name or "pos_embed" in name:
            return 0.2 * z
        return z
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _jax_engine():
    spec = jengine.EngineSpec(clip_frames=15, frame_height=90,
                              frame_width=160, fps=5, yolo_size=64,
                              pose_size=64, dino_size=56, use_sam_model=True,
                              sam_size=128, sam_mask_size=64)
    eng = jengine.LamenessEngine(config=JConfig(), spec=spec,
                                 init_models=False)
    eng.yolo = JYolo(variant="n", num_classes=80)
    eng.dino = jdino.DinoV2(hidden_size=64, num_layers=2, num_heads=4,
                            patch_size=14, pos_grid=4, ls_init=1.0)
    eng.sam = JSam(img_size=128, encoder_dim=64, encoder_depth=2,
                   encoder_heads=4, global_attn_indexes=(1,),
                   fused_global=True)
    eng.tcn = JTCN(input_dim=44, dropout=0.0)
    eng.gait = JGait(input_dim=44, dropout=0.0)
    seq = jnp.zeros((1, 125, 44))
    eng.params = {
        "yolo": _seeded(eng.yolo, jnp.zeros((1, 64, 64, 3)), seed=1),
        "dino": _seeded(eng.dino, jnp.zeros((1, 56, 56, 3)), seed=2),
        "sam": _seeded(eng.sam, jnp.zeros((1, 128, 128, 3)),
                       jnp.zeros((1, 4)), seed=3),
        "tcn": _seeded(eng.tcn, seq, seed=4),
        "gait": _seeded(eng.gait, seq, jnp.zeros((1, 125), bool), seed=5),
    }
    eng.pose_model = None
    eng.loaded_weights = {k: False for k in
                          ("yolo", "dino", "sam", "pose", "tcn", "gait")}
    eng._build_jits()
    return eng


def _port_engine(params):
    eng = make_test_engine(device="cpu", with_sam=True)
    eng.tcn = TCN(input_dim=44, dropout=0.0, device="cpu")
    eng.gait = GaitTransformer(input_dim=44, dropout=0.0, device="cpu")
    eng.load_state_dicts(from_jax_params(params))
    return eng


def _leaves(tree, prefix=""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, f"{prefix}{key}.")
        else:
            yield prefix + key, np.asarray(val)


def _matches_jax_engine(monkeypatch):
    """Both engines on the same seeded clips, held to the gates of the
    module docstring; returns the content rows the port's SAM encoder was
    given (its pad-row split, 0 for none)."""
    jeng = _jax_engine()
    teng = _port_engine(jeng.params)
    rows = []
    encode = teng.sam.encode

    def spy(images, content_rows=0):
        rows.append(content_rows)
        return encode(images, content_rows)
    monkeypatch.setattr(teng.sam, "encode", spy)
    frames = np.random.default_rng(0).integers(0, 256, (2, 15, 90, 160, 3),
                                               dtype=np.uint8)
    want = jeng.process_clip_batch(frames)
    got = teng.process_clip_batch(
        frames, generator=torch.Generator().manual_seed(0))
    _assert_gates(got, want)
    return rows


def _assert_gates(got, want):
    """The port's output tree against the JAX engine's, held to the gates
    of the module docstring (key by key; ``locomotion`` flattened)."""
    want, got = dict(_leaves(want)), dict(_leaves(got))
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        assert g.shape == w.shape and g.dtype == w.dtype, key
        if key == "masks":
            assert (g == w).mean() >= 0.995
        elif key == "mask_iou_pred":
            np.testing.assert_allclose(g, w, atol=1e-3, rtol=0)
        elif w.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            np.testing.assert_allclose(g, w, atol=1e-4, rtol=0,
                                       err_msg=key)
    if "det_valid" in want:
        assert want["det_valid"].any(), \
            "no detection: the comparison is idle"


def test_process_clip_batch_matches_jax_engine(monkeypatch):
    """Landscape 160x90 frames: both engines pass the encoder the content
    rows of the bottom-padded canvas (72 of 128 px: 5 token rows)."""
    monkeypatch.delenv("LAMENESS_SAM_PADSPLIT", raising=False)
    assert _matches_jax_engine(monkeypatch) == [5]


def test_process_clip_batch_without_pad_split(monkeypatch):
    """LAMENESS_SAM_PADSPLIT=0 on both sides (the JAX engine reads it at
    trace time, the port at each call): no content rows reach the encoder,
    and the engines agree within the same gates."""
    monkeypatch.setenv("LAMENESS_SAM_PADSPLIT", "0")
    assert _matches_jax_engine(monkeypatch) == [0]


def test_mc_dropout_heads():
    """Dropout 0.2 from a torch.Generator: the samples spread
    (uncertainty > 0), their mean stays within 0.05 of the deterministic
    forward, and a fixed generator reproduces them."""
    from lameness_tpu_torch.weights import seeded_state_dict
    eng = make_test_engine(device="cpu")
    eng.config = Config(tcn=TcnConfig(mc_samples=64))
    eng.tcn = TCN(input_dim=44, dropout=0.2, device="cpu")
    eng.gait = GaitTransformer(input_dim=44, dropout=0.2, device="cpu")
    init = torch.Generator().manual_seed(1)
    eng.load_state_dicts({"tcn": seeded_state_dict(eng.tcn, init),
                          "gait": seeded_state_dict(eng.gait, init)})
    boxes = torch.tensor([[20.0, 10.0, 120.0, 80.0]]).repeat(2, 8, 1)
    boxes[1] += 5.0
    scores = torch.full((2, 8), 0.9)
    with torch.no_grad():
        out = eng._heads_stage(boxes, scores,
                               torch.Generator().manual_seed(0))
        again = eng._heads_stage(boxes, scores,
                                 torch.Generator().manual_seed(0))
        det_t = eng.tcn(out["seq_features"])[:, 0]
        det_g = eng.gait(out["seq_features"], out["seq_mask"]
                         )["probability"][:, 0]
    for head, det in (("tcn", det_t), ("gait", det_g)):
        assert (out[f"{head}_uncertainty"] > 0).all()
        assert (out[f"{head}_probability"] - det).abs().max() < 0.05
        torch.testing.assert_close(out[f"{head}_probability"],
                                   again[f"{head}_probability"])
        torch.testing.assert_close(out[f"{head}_uncertainty"],
                                   again[f"{head}_uncertainty"])


def test_pack_frames_into_a_buffer():
    """The card's transfer gathers the packed frames into a (pinned) buffer
    with ``pack_frames(out=...)``: the same frames as the plain gather."""
    spec = EngineSpec(frame_height=9, frame_width=16)
    frames = np.random.default_rng(0).integers(0, 256, (2, 125, 9, 16, 3),
                                               dtype=np.uint8)
    want = frames[:, spec.packed_idx]
    assert spec.n_packed == 33
    np.testing.assert_array_equal(spec.pack_frames(frames), want)
    for src in (frames, want):
        out = np.empty_like(want)
        assert spec.pack_frames(src, out=out) is out
        np.testing.assert_array_equal(out, want)
