"""The port's checkpoint loading against the JAX package, on the CPU.

- the converters (HF DINOv2, HF SAM, segment-anything SAM, ultralytics
  YOLO with and without the pose head) give the JAX converters' numpy
  trees exactly, leaf for leaf, on random-weight ``transformers`` models
  (no download) and seeded params;
- ``load_torch_weights("sam", ...)`` rebuilds SAM at the checkpoint's
  variant as the JAX engine does (the same monkeypatched tiny variant in
  both packages), and installs what ``from_jax_params`` makes of the JAX
  engine's params;
- the bf16 policy follows weights installed after it;
- ``restore_engine`` installs ``.pt`` files, skips pose on a trimmed wire,
  and reports a checkpoint it cannot convert;
- a tiny engine at ViT-H's head dim 80 against the JAX engine.
"""
import dataclasses
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lameness_tpu.core.config import Config as JConfig
from lameness_tpu.core.config import SamConfig as JSamConfig
from lameness_tpu.models import dino as jdino
from lameness_tpu.models import sam as jsam
from lameness_tpu.models import yolo as jyolo
from lameness_tpu.pipeline import engine as jengine
from lameness_tpu_torch.core.config import Config, SamConfig
from lameness_tpu_torch.models import dino as tdino
from lameness_tpu_torch.models import sam as tsam
from lameness_tpu_torch.models import yolo as tyolo
from lameness_tpu_torch.models.sam import Sam, build_sam
from lameness_tpu_torch.pipeline import checkpoint
from lameness_tpu_torch.pipeline.engine import (EngineSpec, LamenessEngine,
                                                make_test_engine)
from lameness_tpu_torch.pipeline.precision import apply_engine_policy
from lameness_tpu_torch.weights import (conv_tree_from_state_dict,
                                        from_jax_params, seeded_state_dict)
from tests.test_torch_engine import (_assert_gates, _jax_engine,
                                     _port_engine, _seeded)

transformers = pytest.importorskip("transformers")

TINY_VARIANT = dict(encoder_dim=64, encoder_depth=2, encoder_heads=4,
                    global_attn_indexes=(1,))


def _equal_trees(got, want, path=""):
    """Leaf for leaf: the same keys, dtypes, shapes and values."""
    assert isinstance(got, dict) == isinstance(want, dict), path
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for key in want:
            _equal_trees(got[key], want[key], f"{path}/{key}")
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.dtype == w.dtype and g.shape == w.shape, path
    np.testing.assert_array_equal(g, w, err_msg=path)


@pytest.fixture(scope="module")
def hf_sam():
    """A random-weight HF SamModel (the sam-vit-base geometry)."""
    from transformers import SamConfig as HfSamConfig, SamModel
    torch.manual_seed(0)
    with torch.no_grad():
        return SamModel(HfSamConfig()).eval().state_dict()


# HF SamModel -> segment-anything names: the inverse of
# sa_to_hf_state_dict's rules (first match wins, as there)
_TO_SA = [
    (r"^vision_encoder\.patch_embed\.projection\.",
     "image_encoder.patch_embed.proj."),
    (r"^vision_encoder\.layers\.(\d+)\.layer_norm([12])\.",
     r"image_encoder.blocks.\1.norm\2."),
    (r"^vision_encoder\.layers\.(\d+)\.", r"image_encoder.blocks.\1."),
    (r"^vision_encoder\.neck\.conv1\.", "image_encoder.neck.0."),
    (r"^vision_encoder\.neck\.layer_norm1\.", "image_encoder.neck.1."),
    (r"^vision_encoder\.neck\.conv2\.", "image_encoder.neck.2."),
    (r"^vision_encoder\.neck\.layer_norm2\.", "image_encoder.neck.3."),
    (r"^vision_encoder\.", "image_encoder."),
    (r"^prompt_encoder\.shared_embedding\.positional_embedding$",
     "prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"),
    (r"^prompt_encoder\.point_embed\.", "prompt_encoder.point_embeddings."),
    (r"^prompt_encoder\.mask_embed\.conv1\.",
     "prompt_encoder.mask_downscaling.0."),
    (r"^prompt_encoder\.mask_embed\.layer_norm1\.",
     "prompt_encoder.mask_downscaling.1."),
    (r"^prompt_encoder\.mask_embed\.conv2\.",
     "prompt_encoder.mask_downscaling.3."),
    (r"^prompt_encoder\.mask_embed\.layer_norm2\.",
     "prompt_encoder.mask_downscaling.4."),
    (r"^prompt_encoder\.mask_embed\.conv3\.",
     "prompt_encoder.mask_downscaling.6."),
    (r"^mask_decoder\.transformer\.layer_norm_final_attn\.",
     "mask_decoder.transformer.norm_final_attn."),
    (r"^mask_decoder\.transformer\.layers\.(\d+)\.layer_norm([1-4])\.",
     r"mask_decoder.transformer.layers.\1.norm\2."),
    (r"^mask_decoder\.upscale_conv1\.", "mask_decoder.output_upscaling.0."),
    (r"^mask_decoder\.upscale_layer_norm\.",
     "mask_decoder.output_upscaling.1."),
    (r"^mask_decoder\.upscale_conv2\.", "mask_decoder.output_upscaling.3."),
    (r"^(mask_decoder\.(?:output_hypernetworks_mlps\.\d+|"
     r"iou_prediction_head))\.proj_in\.", r"\1.layers.0."),
    (r"^(mask_decoder\.(?:output_hypernetworks_mlps\.\d+|"
     r"iou_prediction_head))\.layers\.0\.", r"\1.layers.1."),
    (r"^(mask_decoder\.(?:output_hypernetworks_mlps\.\d+|"
     r"iou_prediction_head))\.proj_out\.", r"\1.layers.2."),
]


def _to_sa(sd):
    out = {}
    for key, val in sd.items():
        for pat, rep in _TO_SA:
            new = re.sub(pat, rep, key)
            if new != key:
                key = new
                break
        out[key] = val
    return out


def test_dino_converter_matches_jax():
    from transformers import Dinov2Config, Dinov2Model
    torch.manual_seed(1)
    with torch.no_grad():
        sd = Dinov2Model(Dinov2Config(image_size=518)).eval().state_dict()
    got = tdino.convert_hf_state_dict(sd)
    _equal_trees(got, jdino.convert_hf_state_dict(sd))
    # the port's DinoV2 at the 37x37+1 grid takes the tree as it is
    eng = LamenessEngine(spec=EngineSpec(use_sam_model=False), device="cpu",
                         init_models=False)
    eng.dino = tdino.DinoV2(device="cpu")
    eng.load_torch_weights("dino", sd)
    assert eng.loaded_weights["dino"]
    want = from_jax_params({"dino": got})["dino"]
    for key, val in eng.dino.state_dict().items():
        assert torch.equal(val, want[key]), key


@pytest.mark.parametrize("layout", ["hf", "sa"])
def test_sam_converter_matches_jax(hf_sam, layout):
    sd = hf_sam if layout == "hf" else _to_sa(hf_sam)
    assert tsam.detect_sam_layout(sd) == jsam.detect_sam_layout(sd) == layout
    if layout == "sa":
        renamed = tsam.sa_to_hf_state_dict(sd)
        assert list(renamed) == list(jsam.sa_to_hf_state_dict(sd))
        assert set(renamed) == set(hf_sam)
        got = tsam.convert_sa_state_dict(sd)
        _equal_trees(got, jsam.convert_sa_state_dict(sd))
    else:
        got = tsam.convert_hf_state_dict(sd)
        _equal_trees(got, jsam.convert_hf_state_dict(sd))
    # both layouts give one tree, and it fits the port's vit_b exactly
    _equal_trees(got, jsam.convert_hf_state_dict(hf_sam))
    want = build_sam("vit_b", device="cpu").state_dict()
    sd_port = from_jax_params({"sam": got})["sam"]
    assert set(sd_port) == set(want)
    assert all(sd_port[k].shape == want[k].shape for k in want)


def test_sam_layout_and_variant_helpers():
    with pytest.raises(ValueError):
        tsam.detect_sam_layout({"foo.weight": np.zeros(1)})
    for dim, name in ((768, "vit_b"), (1024, "vit_l"), (1280, "vit_h")):
        assert tsam.infer_variant(dim) == jsam.infer_variant(dim) == name
    with pytest.raises(ValueError):
        tsam.infer_variant(512)
    assert tsam.SAM_VARIANTS == jsam.SAM_VARIANTS


@pytest.mark.parametrize("has_pose", [False, True])
def test_yolo_converter_matches_jax(has_pose):
    model = jyolo.YoloV8(variant="n", num_classes=1 if has_pose else 80,
                         num_keypoints=20 if has_pose else 0)
    params = jax.tree_util.tree_map(
        np.asarray, _seeded(model, jnp.zeros((1, 64, 64, 3)), seed=7))
    sd = jyolo.export_ultralytics_state_dict(params, has_pose=has_pose)
    got_sd = tyolo.export_ultralytics_state_dict(params, has_pose=has_pose)
    assert list(got_sd) == list(sd)
    for key in sd:
        np.testing.assert_array_equal(got_sd[key], sd[key], err_msg=key)
    # the file layout: torch tensors, "model." prefixes
    torch_sd = {f"model.{k}": torch.as_tensor(v) for k, v in sd.items()}
    got = tyolo.convert_ultralytics_state_dict(torch_sd, has_pose=has_pose)
    _equal_trees(got, jyolo.convert_ultralytics_state_dict(
        torch_sd, has_pose=has_pose))
    _equal_trees(got, params)
    # and back: the port's own YOLO state dict, through the conv inverse
    tmodel = tyolo.YoloV8("n", num_classes=1 if has_pose else 80,
                          num_keypoints=20 if has_pose else 0, device="cpu")
    seeded = seeded_state_dict(tmodel, torch.Generator().manual_seed(0))
    back = from_jax_params({"m": conv_tree_from_state_dict(seeded)})["m"]
    assert list(back) == list(seeded)
    assert all(torch.equal(back[k], seeded[k]) for k in seeded)


def test_load_torch_weights_switches_variant(monkeypatch, hf_sam):
    """A vit_b checkpoint into engines built at a tiny variant: both
    rebuild SAM at vit_b, and the port's SAM holds what from_jax_params
    makes of the JAX engine's installed params."""
    monkeypatch.setitem(jsam.SAM_VARIANTS, "vit_t", TINY_VARIANT)
    monkeypatch.setitem(tsam.SAM_VARIANTS, "vit_t", TINY_VARIANT)
    kw = dict(clip_frames=25, frame_height=72, frame_width=128,
              yolo_size=64, pose_size=64, dino_size=28, sam_size=1024,
              sam_mask_size=64)
    jeng = jengine.LamenessEngine(
        config=JConfig(sam=JSamConfig(variant="vit_t")),
        spec=jengine.EngineSpec(**kw), init_models=False)
    jeng.sam = jsam.build_sam("vit_t", img_size=1024)
    jeng.params, jeng.pose_model = {}, None
    jeng.loaded_weights = {k: False for k in
                           ("yolo", "dino", "sam", "pose", "tcn", "gait")}
    teng = LamenessEngine(config=Config(sam=SamConfig(variant="vit_t")),
                          spec=EngineSpec(**kw), device="cpu",
                          init_models=False)
    teng.sam = build_sam("vit_t", img_size=1024, device="cpu")
    assert teng.sam.encoder_dim == 64
    jeng.load_torch_weights("sam", hf_sam)
    teng.load_torch_weights("sam", hf_sam)
    assert jeng.sam.encoder_dim == teng.sam.encoder_dim == 768
    assert len([m for m in teng.sam.vision_encoder.children()
                if isinstance(m, tsam.VisionLayer)]) == 12
    assert teng.loaded_weights["sam"] and jeng.loaded_weights["sam"]
    want = from_jax_params({"sam": jeng.params["sam"]})["sam"]
    got = teng.sam.state_dict()
    assert set(got) == set(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    with pytest.raises(ValueError):
        teng.load_torch_weights("tcn", {})


def test_policy_follows_installed_weights(monkeypatch, hf_sam):
    """Under the bf16 policy a SAM rebuilt at another variant and a new
    pose model are cast as the policy casts (SAM's encoder, YOLO-style BN
    kept f32); a module already cast keeps its dtypes."""
    monkeypatch.setitem(tsam.SAM_VARIANTS, "vit_t", TINY_VARIANT)
    eng = LamenessEngine(config=Config(sam=SamConfig(variant="vit_t")),
                         spec=EngineSpec(use_sam_model=True), device="cpu",
                         init_models=False)
    eng.sam = build_sam("vit_t", device="cpu")
    eng.yolo = tyolo.YoloV8("n", device="cpu")
    eng.dino = tdino.DinoV2(hidden_size=64, num_layers=1, num_heads=4,
                            device="cpu")
    summary = apply_engine_policy(eng)
    assert set(summary) == {"yolo", "dino", "sam"}
    assert eng.spec.dtype == torch.bfloat16
    eng.load_torch_weights("sam", hf_sam)
    enc = dict(eng.sam.vision_encoder.named_parameters())
    assert enc["layer0.attn.qkv.weight"].dtype == torch.bfloat16
    assert enc["neck_ln1.weight"].dtype == torch.float32
    assert all(p.dtype == torch.float32
               for p in eng.sam.mask_decoder.parameters())
    want = tsam.convert_hf_state_dict(hf_sam)["params"]["vision_encoder"]
    np.testing.assert_array_equal(
        enc["pos_embed"].detach().float().numpy(),
        torch.from_numpy(want["pos_embed"]).to(torch.bfloat16).float().numpy())
    pose = tyolo.YoloV8("n", num_classes=1, num_keypoints=20, device="cpu")
    eng.install_pose_params(conv_tree_from_state_dict(
        seeded_state_dict(pose, torch.Generator().manual_seed(0))))
    dtypes = {k: p.dtype for k, p in eng.pose_model.named_parameters()}
    assert dtypes["pose0.kpt2.weight"] == torch.bfloat16
    assert dtypes["pose0.kpt0.bn.var"] == torch.float32
    assert eng.precision["pose"] == "bf16 (bn stats f32)"
    yolo_sd = tyolo.export_ultralytics_state_dict(
        conv_tree_from_state_dict(seeded_state_dict(
            eng.yolo, torch.Generator().manual_seed(1))))
    eng.load_torch_weights("yolo", {k: torch.as_tensor(v)
                                    for k, v in yolo_sd.items()})
    assert eng.yolo.stem.conv.weight.dtype == torch.bfloat16
    assert eng.yolo.stem.bn.mean.dtype == torch.float32


def _save(path, sd):
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({k: torch.as_tensor(v) for k, v in sd.items()}, path)


def test_restore_engine_installs_torch_files(tmp_path):
    src = make_test_engine(device="cpu",
                           generator=torch.Generator().manual_seed(5))
    yolo_tree = conv_tree_from_state_dict(src.yolo.state_dict())
    _save(tmp_path / "yolo" / "yolov8n.pt",
          tyolo.export_ultralytics_state_dict(yolo_tree))
    pose = tyolo.YoloV8("n", num_classes=1, num_keypoints=20, device="cpu")
    pose_tree = conv_tree_from_state_dict(
        seeded_state_dict(pose, torch.Generator().manual_seed(6)))
    _save(tmp_path / "pose" / "cow_pose.pt",
          tyolo.export_ultralytics_state_dict(pose_tree, has_pose=True))
    (tmp_path / "dino").mkdir()
    (tmp_path / "dino" / "notes.bin").write_text("not a checkpoint")
    eng = make_test_engine(device="cpu")
    loaded = checkpoint.restore_engine(eng, tmp_path)
    assert loaded == {"yolo": True, "dino": False, "tcn": False,
                      "gait": False, "pose": True}
    for key, val in src.yolo.state_dict().items():
        assert torch.equal(eng.yolo.state_dict()[key], val), key
    assert eng.loaded_weights["yolo"] and eng.loaded_weights["pose"]
    assert not eng.loaded_weights["dino"]
    want = from_jax_params({"pose": pose_tree})["pose"]
    for key, val in eng.pose_model.state_dict().items():
        assert torch.equal(val, want[key]), key
    assert checkpoint.try_load_torch(tmp_path, "sam") is None


def test_restore_engine_reports_a_bad_checkpoint(tmp_path, capsys):
    _save(tmp_path / "yolo" / "broken.pt", {"0.conv.weight": np.zeros(1)})
    eng = make_test_engine(device="cpu")
    before = {k: v.clone() for k, v in eng.yolo.state_dict().items()}
    assert checkpoint.restore_engine(eng, tmp_path)["yolo"] is False
    assert "yolo checkpoint not installed" in capsys.readouterr().err
    assert not eng.loaded_weights["yolo"]
    assert all(torch.equal(eng.yolo.state_dict()[k], v)
               for k, v in before.items())


def test_restore_engine_skips_pose_on_trimmed_wire(tmp_path, capsys):
    eng = make_test_engine(device="cpu")
    trimmed = eng.with_spec(dataclasses.replace(eng.spec, pose_pixels=False))
    (tmp_path / "pose").mkdir()
    loaded = checkpoint.restore_engine(trimmed, tmp_path)
    assert loaded.get("pose") is False
    assert not trimmed.loaded_weights.get("pose")
    assert "pose_pixels=False" in capsys.readouterr().err


HD80 = dict(encoder_dim=160, encoder_depth=3, encoder_heads=2,
            global_attn_indexes=(1,))


def test_tiny_head_dim_80_engine_matches_jax(monkeypatch):
    """ViT-H's head dim 80 (tests/test_sam_variants.py's vit_h_mini: 160
    wide, 2 heads) in the tiny engine: the port (the plain versions of
    K2 and K3 at hd 80) against the JAX engine's fused Pallas path."""
    monkeypatch.delenv("LAMENESS_SAM_PADSPLIT", raising=False)
    jeng = _jax_engine()
    jeng.sam = jsam.Sam(img_size=128, fused_global=True, **HD80)
    jeng.params["sam"] = _seeded(jeng.sam, jnp.zeros((1, 128, 128, 3)),
                                 jnp.zeros((1, 4)), seed=8)
    jeng._build_jits()
    teng = _port_engine({k: v for k, v in jeng.params.items()
                         if k != "sam"})
    teng.sam = Sam(img_size=128, device="cpu", **HD80)
    teng.load_state_dicts(from_jax_params({"sam": jeng.params["sam"]}))
    assert teng.sam.encoder_dim // 2 == 80
    frames = np.random.default_rng(0).integers(0, 256, (2, 15, 90, 160, 3),
                                               dtype=np.uint8)
    want = jeng.process_clip_batch(frames)
    got = teng.process_clip_batch(frames,
                                  generator=torch.Generator().manual_seed(0))
    _assert_gates(got, want)
