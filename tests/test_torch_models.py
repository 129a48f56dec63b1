"""The port's modules against their flax counterparts, on the CPU.

Weights and inputs are drawn with numpy from a seed and handed to both
sides (the port's through ``weights.from_jax_params``).  Pallas kernels on
the JAX side run in interpret mode; the port runs its plain PyTorch path.
Tolerances: 1e-4 for the conv/ViT stacks (f32 sums in other orders over
a few thousand products), 1e-5 for the small heads, 1e-6 for the pose and
sequence-feature arithmetic, 1e-3 for resizes on 0-255 frames.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lameness_tpu.models import dino as jdino
from lameness_tpu.models import pose as jpose
from lameness_tpu.models import sam as jsam
from lameness_tpu.models import sequence_features as jseqf
from lameness_tpu.models import yolo as jyolo
from lameness_tpu.models.gait_transformer import GaitTransformer as JGait
from lameness_tpu.models.tcn import TCN as JTCN
from lameness_tpu.ops import preprocess as jprep
from lameness_tpu.pipeline import engine as jengine
from lameness_tpu_torch.models import dino as tdino
from lameness_tpu_torch.models import pose as tpose
from lameness_tpu_torch.models import sam as tsam
from lameness_tpu_torch.models import sequence_features as tseqf
from lameness_tpu_torch.models import yolo as tyolo
from lameness_tpu_torch.models.gait_transformer import GaitTransformer
from lameness_tpu_torch.models.tcn import TCN
from lameness_tpu_torch.ops import preprocess as tprep
from lameness_tpu_torch.pipeline import engine as tengine
from lameness_tpu_torch.weights import from_jax_params


def _seeded(module, *args, seed: int):
    """Numpy params for a flax module, drawn from a seed at the shapes its
    init would give (``eval_shape``: no init program is compiled)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = leaf.shape
        z = rng.standard_normal(shape).astype(np.float32)
        if name.endswith("['var']"):                 # BN variance > 0
            return 1.0 + 0.2 * np.abs(z)
        if name.endswith(("['scale']", "['g']")):
            return 1.0 + 0.1 * z
        if name.endswith(("['bias']", "['b']", "['mean']")):
            return 0.1 * z
        if name.endswith(("['kernel']", "['v']")):
            return z / np.sqrt(np.prod(shape[:-1]))
        if "upscale_conv" in name and len(shape) == 4:
            return z / np.sqrt(shape[0])
        if "rel_pos" in name or "pos_embed" in name:
            return 0.2 * z
        return z                                      # tokens, embeddings
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _load(module, params):
    module.load_state_dict(from_jax_params({"m": params})["m"], strict=True)
    return module.eval()


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


def test_yolo_levels_match_flax():
    jm = jyolo.YoloV8(variant="n", num_classes=80)
    x = np.random.default_rng(2).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    params = _seeded(jm, jnp.zeros((1, 64, 64, 3)), seed=1)
    want = jax.jit(jm.apply)(params, jnp.asarray(x))["levels"]
    tm = _load(tyolo.YoloV8("n", num_classes=80, device="cpu"), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))["levels"]
    for g, w in zip(got, want):
        for key in ("box", "cls"):
            assert g[key].shape == w[key].shape
            _close(g[key].numpy(), w[key], 1e-4)


@pytest.mark.parametrize("hw,seed", [((80, 80), 3), ((20, 20), 4)])
def test_detect_selects_the_same_boxes(hw, seed):
    """Decode + top-k (at 80x80 there are 8400 anchors, past the 256 cut)
    + fixed-K NMS on the same raw levels.  Compared as selected sets: torch
    .topk orders exact ties differently from lax.top_k."""
    rng = np.random.default_rng(seed)
    h, w = hw
    levels = [{"box": rng.standard_normal((2, h // s, w // s, 64)
                                          ).astype(np.float32),
               "cls": rng.standard_normal((2, h // s, w // s, 80)
                                          ).astype(np.float32) - 2.0}
              for s in (1, 2, 4)]
    want = jax.jit(lambda lv: jyolo.detect(lv, conf_threshold=0.5,
                                           max_det=8))(
        [{k: jnp.asarray(v) for k, v in lv.items()} for lv in levels])
    got = tyolo.detect([{k: torch.from_numpy(v) for k, v in lv.items()}
                        for lv in levels], conf_threshold=0.5, max_det=8)
    for i in range(2):
        wv = np.asarray(want["valid"][i])
        gv = got["valid"][i].numpy()
        assert wv.sum() == gv.sum() > 0
        key = lambda b, s, c: sorted(map(tuple, np.round(np.concatenate(
            [b, s[:, None], c[:, None]], 1), 3)))
        assert key(got["boxes"][i].numpy()[gv], got["scores"][i].numpy()[gv],
                   got["classes"][i].numpy()[gv]) == key(
            np.asarray(want["boxes"][i])[wv], np.asarray(want["scores"][i])[wv],
            np.asarray(want["classes"][i])[wv])
    assert got["classes"].dtype == torch.int32


def test_dino_pooled_matches_flax():
    """64-wide, 2-layer DINOv2 at the default 224² input: the 37-grid
    position table resizes bicubically to 16 (antialiased, as JAX does)."""
    jm = jdino.DinoV2(hidden_size=64, num_layers=2, num_heads=4,
                      patch_size=14, pos_grid=37, ls_init=1.0,
                      use_pallas=False)
    x = np.random.default_rng(5).standard_normal((2, 224, 224, 3)).astype(
        np.float32)
    params = _seeded(jm, jnp.zeros((1, 224, 224, 3)), seed=6)
    want = jax.jit(jm.apply)(params, jnp.asarray(x))
    tm = _load(tdino.DinoV2(hidden_size=64, num_layers=2, num_heads=4,
                            pos_grid=37, ls_init=1.0, device="cpu"), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    _close(got["pooled"].numpy(), want["pooled"], 1e-4)
    _close(got["last_hidden_state"].numpy(), want["last_hidden_state"], 1e-4)


@pytest.mark.parametrize("img,dim,heads,batch,content_rows", [
    (128, 64, 4, 2, 0),          # the engine test's SAM: 8² grid
    (288, 32, 2, 2, 10),         # 18² grid: pad-row split, global > 16
])
def test_sam_encoder_and_decoder_match_flax(img, dim, heads, batch,
                                            content_rows):
    jm = jsam.Sam(img_size=img, encoder_dim=dim, encoder_depth=2,
                  encoder_heads=heads, global_attn_indexes=(1,),
                  fused_global=True)
    params = _seeded(jm, jnp.zeros((1, img, img, 3)), jnp.zeros((1, 4)),
                     seed=7)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((batch, img, img, 3)).astype(np.float32)
    if content_rows:
        x[:, content_rows * 16:] = 0.3      # identical pad rows
    boxes = np.asarray([[10.0, 12.0, 90.0, 70.0]] * batch, np.float32)
    emb = jax.jit(lambda p, x: jm.apply(p, x, content_rows,
                                        method=jm.encode))(params,
                                                           jnp.asarray(x))
    masks, iou = jax.jit(lambda p, e, b: jm.apply(
        p, e, b, method=jm.decode_boxes))(params, emb, jnp.asarray(boxes))
    tm = _load(tsam.Sam(img_size=img, encoder_dim=dim, encoder_depth=2,
                        encoder_heads=heads, global_attn_indexes=(1,),
                        device="cpu"), params)
    with torch.no_grad():
        temb = tm.encode(torch.from_numpy(x), content_rows)
        tmasks, tiou = tm.decode_boxes(temb, torch.from_numpy(boxes))
    _close(temb.numpy(), emb, 1e-4)
    _close(tmasks.numpy(), masks, 1e-4)
    _close(tiou.numpy(), iou, 1e-4)


def test_sequence_heads_match_flax():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 125, 44)).astype(np.float32)
    mask = rng.uniform(size=(2, 125)) < 0.2
    jt, jg = JTCN(input_dim=44), JGait(input_dim=44)
    pt = _seeded(jt, jnp.asarray(x), seed=10)
    pg = _seeded(jg, jnp.asarray(x), jnp.asarray(mask), seed=11)
    want_t = jax.jit(jt.apply)(pt, jnp.asarray(x))
    want_g = jax.jit(jg.apply)(pg, jnp.asarray(x), jnp.asarray(mask))
    tt = _load(TCN(input_dim=44, device="cpu"), pt)
    tg = _load(GaitTransformer(input_dim=44, device="cpu"), pg)
    with torch.no_grad():
        got_t = tt(torch.from_numpy(x))
        got_g = tg(torch.from_numpy(x), torch.from_numpy(mask))
    _close(got_t.numpy(), want_t, 1e-5)
    for key in ("probability", "pooled", "saliency"):
        _close(got_g[key].numpy(), want_g[key], 1e-5)


def test_pose_and_sequence_features_match_jax():
    rng = np.random.default_rng(12)
    b, t = 2, 25
    xy = rng.uniform(0, 600, (b, t, 2)).astype(np.float32)
    wh = rng.uniform(20, 400, (b, t, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], -1)
    scores = rng.uniform(0.2, 1.0, (b, t)).astype(np.float32)
    valid = rng.uniform(size=(b, t)) > 0.15
    jk = jpose.heuristic_keypoints_device(jnp.asarray(boxes))
    tk = tpose.heuristic_keypoints_device(torch.from_numpy(boxes))
    _close(tk.numpy(), jk, 1e-6)
    kp = np.array(jk)
    kp[..., 2] = rng.uniform(0, 1, kp.shape[:-1])     # mixed confidence
    want = jax.jit(jax.vmap(jpose.locomotion_features_device))(
        jnp.asarray(kp[..., :2]), jnp.asarray(kp[..., 2]), jnp.asarray(valid))
    got = tpose.locomotion_features_device(
        torch.from_numpy(kp[..., :2]), torch.from_numpy(kp[..., 2]),
        torch.from_numpy(valid))
    assert set(got) == set(want)
    for key in want:
        _close(got[key].numpy(), want[key], 1e-6 * max(
            1.0, float(np.abs(np.asarray(want[key])).max())))
    wf, wm = jax.jit(jax.vmap(jseqf.extract_from_arrays))(
        jnp.asarray(kp[..., :2]), jnp.asarray(kp[..., 2]),
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid))
    gf, gm = tseqf.extract_from_arrays(
        torch.from_numpy(kp[..., :2]), torch.from_numpy(kp[..., 2]),
        torch.from_numpy(boxes), torch.from_numpy(scores),
        torch.from_numpy(valid))
    _close(gf.numpy(), wf, 1e-6)
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))


@pytest.mark.parametrize("op,hw", [("letterbox", (90, 160)),
                                   ("letterbox", (720, 1280)),
                                   ("pad_to_rect", (90, 160)),
                                   ("pad_to_rect", (720, 1280)),
                                   ("dino_preprocess", (720, 1280))])
def test_resizes_match_jax_on_0_255_frames(op, hw):
    """Every resize antialiases like jax.image.resize (without
    antialias=True torch differs by up to 156/255 on downscale)."""
    frames = np.random.default_rng(13).integers(0, 256, (1, *hw, 3),
                                                dtype=np.uint8)
    tf = torch.from_numpy(frames)
    if op == "letterbox":
        size = 64 if hw[0] == 90 else 640
        wc, wr, wp = jax.vmap(lambda f: jprep.letterbox(f, size))(
            jnp.asarray(frames))
        gc, gr, gp = tprep.letterbox(tf, size)
        _close(gr.numpy(), wr, 1e-6)
        _close(gp.numpy(), wp, 0)
    elif op == "pad_to_rect":
        size = 128 if hw[0] == 90 else 1024
        wc = jax.vmap(lambda f: jprep.pad_to_rect(f, (size, size), size)[0])(
            jnp.asarray(frames))
        gc, _ = tprep.pad_to_rect(tf, (size, size), size)
    else:
        wc = jdino.preprocess_frames(jnp.asarray(frames))
        gc = tdino.preprocess_frames(tf)
    assert gc.shape == wc.shape
    _close(gc.numpy(), wc, 1e-3)


def test_unpad_mask_logits_matches_jax():
    m = np.random.default_rng(14).standard_normal((3, 32, 32)).astype(
        np.float32) * 5
    want = jengine.unpad_mask_logits(jnp.asarray(m), 18, 32, 64)
    got = tengine.unpad_mask_logits(torch.from_numpy(m), 18, 32, 64)
    _close(got.numpy(), want, 1e-4)
