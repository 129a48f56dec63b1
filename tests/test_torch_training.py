"""The port's trainers (``lameness_tpu_torch/pipeline/{optim,detect_training,
pose_training,head_training,graph_training,evaluation}.py``,
``models/sequence_features.py``) against the JAX package on the CPU.

- The optimiser rule: ``clip_by_global_norm`` + ``AdamW`` against optax's
  ``chain(clip_by_global_norm, adamw)`` on the same tensors.
- The TAL assigner against JAX's on inputs with and without ties (multi-
  claimed anchors, equal align scores, the cold-start fallback): every
  output equal.
- Each trainer's step against the JAX step on the same numpy-seeded batch,
  with the port's seeded weights carried across (YOLO by
  ``weights.conv_tree_from_state_dict``, the others from JAX's init by
  ``weights.from_jax_params``): the loss parts of two steps, then every
  parameter (and ``DetectTrainer``'s EMA).  ``DetectTrainer`` runs as the
  JAX package's own; where JAX builds its step inside a closure
  (``train_pose_model``, ``train_heads``, ``train_graph_heads``) the test
  builds the same loss and optax chain from JAX's modules.  The sequence
  heads run with dropout 0 on both sides.
- The datasets (``build_dataset``, ``build_graph_dataset``), the host
  feature copies and mAP equal to JAX's; the trainers' entry points end to
  end with their checkpoints restored; dropout (port only) seeded and
  spread.

Tolerances.  The first step (same weights on both sides) is checked
tightly: its loss parts within 1e-5 relative, and the gradient Adam saw
(the port's ``.grad`` after clipping against JAX's, read from optax's first
moment as ``mu / (1 - b1)``) within 1e-4 of the largest gradient element
(Graphormer: 5e-4; its gradients were measured up to 1.4e-4 apart, at
2e-4 relative on single elements, while its loss agrees within 2e-6).
Adam's update is ``g / (|g| + eps)`` per element, so an element whose
gradient is zero but for f32 rounding (a key bias under softmax, padding
rows, cancelling weight-norm kernels) moves by anything up to a whole
step, lr, either way, and later steps carry that on.  So after the second
step: loss parts within 2e-4 relative, and the parameters (and the EMA)
with at least 90% of the model's elements within 2% of one step, and
every element within 4·lr (Adam moves an element at most about lr a step
at these betas, so two steps on each side, in opposite directions, part
it by at most that: a bound against blow-ups only).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lameness_tpu.models import sequence_features as jseqf
from lameness_tpu.models.gait_transformer import GaitTransformer as JGait
from lameness_tpu.models.graphgps import EnhancedGraphGPS as JGraphGPS
from lameness_tpu.models.graphormer import \
    CowLamenessGraphormer as JGraphormer
from lameness_tpu.models.tcn import TCN as JTCN
from lameness_tpu.models.yolo import YoloV8 as JYolo
from lameness_tpu.pipeline import detect_training as jdt
from lameness_tpu.pipeline import evaluation as jev
from lameness_tpu.pipeline import graph_training as jgt
from lameness_tpu.pipeline import head_training as jht
from lameness_tpu.pipeline import pose_training as jpt
from lameness_tpu.serve.graph_runner import GraphHeadRunner as JRunner
from lameness_tpu_torch.models import sequence_features as tseqf
from lameness_tpu_torch.models.gait_transformer import GaitTransformer
from lameness_tpu_torch.models.graphgps import EnhancedGraphGPS
from lameness_tpu_torch.models.graphormer import CowLamenessGraphormer
from lameness_tpu_torch.models.tcn import TCN
from lameness_tpu_torch.models.yolo import YoloV8
from lameness_tpu_torch.pipeline import checkpoint
from lameness_tpu_torch.pipeline import detect_training as tdt
from lameness_tpu_torch.pipeline import evaluation as tev
from lameness_tpu_torch.pipeline import graph_training as tgt
from lameness_tpu_torch.pipeline import head_training as tht
from lameness_tpu_torch.pipeline import pose_training as tpt
from lameness_tpu_torch.pipeline.engine import make_test_engine
from lameness_tpu_torch.pipeline.optim import Optimizer, clip_by_global_norm
from lameness_tpu_torch.serve.graph_runner import (gnn_inputs, gt_inputs,
                                                   on_device)
from lameness_tpu_torch.weights import (conv_tree_from_state_dict,
                                        from_jax_params, seeded_state_dict)
from tests.test_graph_training import _labeled_graph_data
from tests.test_head_training import _make_labeled_video

LOSS_RTOL = (1e-5, 2e-4)           # first step, second step
GRAD_ATOL = 1e-4                   # of the largest gradient element
PARAM_STEPS = 0.02                 # of one step, lr ...
PARAM_SHARE = 0.9                  # ... for this share of the elements
CANVAS = 64


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: its steps are chains of small
    tensor ops, and a pool of threads per op crawls when the test workers
    share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_grads(modules, opt_state, atol=GRAD_ATOL):
    """The first step's clipped gradients ({name: module}'s ``.grad``)
    against JAX's: optax's first moment after one step is (1 - b1)·g, with
    the params' tree structure ({name: tree} for several modules)."""
    mu = optax.tree_utils.tree_get(opt_state, "mu")
    if len(modules) == 1:
        mu = {next(iter(modules)): mu}
    want = from_jax_params(_np_tree(jax.tree_util.tree_map(
        lambda m: m / 0.1, mu)))
    scale = max(float(np.abs(w.numpy()).max())
                for sd in want.values() for w in sd.values())
    for name, module in modules.items():
        got = {k: p.grad for k, p in module.named_parameters()}
        assert set(got) == set(want[name])
        for key, val in want[name].items():
            np.testing.assert_allclose(got[key].numpy(), val.numpy(),
                                       atol=atol * scale, rtol=0,
                                       err_msg=key)


def _assert_close(got, want, lr):
    """{key: array} against {key: array}: every element within 4·lr, and
    PARAM_SHARE of all elements within PARAM_STEPS·lr."""
    assert set(got) == set(want)
    close = total = 0
    for key, val in got.items():
        diff = np.abs(np.asarray(val) - np.asarray(want[key]))
        assert diff.max() <= 4 * lr, (key, float(diff.max()))
        close += int((diff <= PARAM_STEPS * lr).sum())
        total += diff.size
    assert close >= PARAM_SHARE * total, close / total


def _assert_params(module, jax_tree, lr):
    want = from_jax_params({"m": _np_tree(jax_tree)})["m"]
    _assert_close({k: v.detach().numpy()
                   for k, v in module.named_parameters()},
                  {k: v.numpy() for k, v in want.items()}, lr)


# ---------------------------------------------------------------------------
# the optimiser rule
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_optimizer_matches_optax(max_norm):
    """Three steps of clip + AdamW (weight decay 1e-4) on fixed gradients,
    one leaf without a gradient (optax decays it all the same)."""
    rng = np.random.default_rng(1)
    shapes = [(3, 4), (5,), (2, 2, 2)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(3)]
    for g in grads:
        g[2][:] = 0.0
    tx = optax.chain(optax.clip_by_global_norm(max_norm), optax.adamw(1e-2))
    jp = [jnp.asarray(p) for p in p0]
    state = tx.init(jp)
    params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt = Optimizer(params, 1e-2, max_norm=max_norm)
    for g in grads:
        upd, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        loss = sum((p * torch.from_numpy(x)).sum()
                   for p, x in zip(params[:2], g[:2]))
        opt.step(loss)
    for p, w in zip(params, jp):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(w),
                                   atol=1e-6, rtol=0)


def test_clip_by_global_norm_formula():
    """g · c / norm only where norm >= c, no epsilon."""
    g = [torch.tensor([3.0, 4.0]), torch.tensor([0.0])]
    norm = clip_by_global_norm(g, 1.0)
    assert float(norm) == 5.0
    assert torch.equal(g[0], torch.tensor([3.0, 4.0]) / 5.0)
    g = [torch.tensor([3.0, 4.0])]
    clip_by_global_norm(g, 6.0)
    assert torch.equal(g[0], torch.tensor([3.0, 4.0]))


# ---------------------------------------------------------------------------
# the TAL assigner
# ---------------------------------------------------------------------------
def _assign_inputs(case, seed=0):
    rng = np.random.default_rng(seed)
    b, m, c, g = 2, 4, 3, 8
    xs = (np.arange(g) + 0.5) * 8
    gx, gy = np.meshgrid(xs, xs)
    anchors = np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float32)
    a = len(anchors)
    gt = np.zeros((b, m, 4), np.float32)
    for i in range(b):
        for j in range(m):
            x, y = rng.uniform(0, 40, 2)
            w, h = rng.uniform(10, 30, 2)
            gt[i, j] = [x, y, x + w, y + h]
    labels = rng.integers(0, c, (b, m))
    mask = np.ones((b, m), bool)
    mask[1, 3] = False
    scores = rng.uniform(0.05, 0.95, (b, a, c)).astype(np.float32)
    d = rng.uniform(2, 20, (b, a, 4)).astype(np.float32)
    boxes = np.concatenate([anchors[None] - d[..., :2],
                            anchors[None] + d[..., 2:]], -1)
    if case == "ties":
        # identical gts (equal IoUs for every multi-claimed anchor), one
        # shared predicted box and score everywhere (equal align scores at
        # the top-k cut), gts on cell borders
        gt[:, 1] = gt[:, 0]
        gt[0, 2] = [8, 8, 40, 40]
        labels[:, 1] = labels[:, 0]
        scores[:] = 0.5
        boxes[:] = np.array([10, 10, 36, 36], np.float32)
    elif case == "cold":
        # collapsed predictions: every IoU 0, only the fallback assigns;
        # two gts share their nearest anchor
        boxes[:] = 0.0
        gt[0, 1] = gt[0, 0] + 1.0
    return scores, boxes, anchors, labels, gt, mask


@pytest.mark.parametrize("case", ["random", "ties", "cold"])
def test_task_aligned_assign_matches_jax(case):
    args = _assign_inputs(case)
    want = jdt.task_aligned_assign(*map(jnp.asarray, args))
    got = tdt.task_aligned_assign(*map(torch.from_numpy, args))
    names = ("labels", "boxes", "scores", "fg", "gt_idx")
    for name, g, w in zip(names, got, want):
        g, w = g.numpy(), np.asarray(w)
        if name == "scores":
            np.testing.assert_allclose(g, w, atol=1e-6, rtol=0)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    if case != "random":
        assert np.asarray(want[3]).any()


# ---------------------------------------------------------------------------
# DetectTrainer
# ---------------------------------------------------------------------------
def _yolo_pair(nc, nk=0, seed=0):
    """The port's YOLO with seeded weights and the same weights as a flax
    tree (numpy leaves) for the JAX model."""
    model = YoloV8("n", num_classes=nc, num_keypoints=nk, device="cpu")
    model.load_state_dict(seeded_state_dict(
        model, torch.Generator().manual_seed(seed)))
    jmodel = JYolo(variant="n", num_classes=nc, num_keypoints=nk)
    return model, jmodel, conv_tree_from_state_dict(model.state_dict())


def _det_batch(rng, b=3, m=2, nk=0):
    images = rng.uniform(0, 1, (b, CANVAS, CANVAS, 3)).astype(np.float32)
    boxes = np.zeros((b, m, 4), np.float32)
    labels = np.zeros((b, m), np.int64)
    mask = np.zeros((b, m), bool)
    kpts = np.zeros((b, m, max(nk, 1), 3), np.float32)
    for i in range(b):
        x, y = rng.uniform(2, 30, 2)
        w, h = rng.uniform(14, 32, 2)
        boxes[i, 0] = [x, y, x + w, y + h]
        labels[i, 0] = i % 2
        mask[i, 0] = True
        kpts[i, 0, :, 0] = rng.uniform(x, x + w, max(nk, 1))
        kpts[i, 0, :, 1] = rng.uniform(y, y + h, max(nk, 1))
        kpts[i, 0, :, 2] = rng.uniform(0, 1, max(nk, 1)) > 0.3
    return images, labels, boxes, mask, (kpts if nk else None)


@pytest.mark.parametrize("nk", [0, 20], ids=["detect", "keypoints"])
def test_detect_trainer_steps_match_jax(nk):
    model, jmodel, tree = _yolo_pair(2 if not nk else 1, nk)
    batch = _det_batch(np.random.default_rng(3), nk=nk)
    jtr = jdt.DetectTrainer(jmodel, tree["params"], lr=1e-3, ema_tau=3.0)
    ttr = tdt.DetectTrainer(model, lr=1e-3, ema_tau=3.0, device="cpu")
    for rtol in LOSS_RTOL:
        want = jtr.train_step(*(None if x is None else jnp.asarray(x)
                                for x in batch))
        got = ttr.train_step(*batch)
        if rtol == LOSS_RTOL[0]:
            _assert_grads({"m": model}, jtr.opt_state)
        assert set(got) == set(want)
        assert want["n_fg"] > 0
        for key, val in want.items():
            assert got[key] == pytest.approx(val, rel=rtol), key
    _assert_params(model, {"params": jtr.params}, 1e-3)
    want = from_jax_params({"m": _np_tree({"params": jtr.ema_params})})["m"]
    _assert_close({k: v.numpy() for k, v in ttr.ema_params.items()},
                  {k: v.numpy() for k, v in want.items()}, 1e-3)


def test_detection_loss_finite_without_gt():
    model, _, _ = _yolo_pair(2)
    images, labels, boxes, mask, _ = _det_batch(np.random.default_rng(0))
    mask[:] = False
    loss, aux = tdt.detection_loss(model(torch.from_numpy(images))["levels"],
                                   torch.from_numpy(labels),
                                   torch.from_numpy(boxes),
                                   torch.from_numpy(mask), 2)
    assert torch.isfinite(loss) and float(aux["n_fg"]) == 0


# ---------------------------------------------------------------------------
# the pose trainer
# ---------------------------------------------------------------------------
def _pose_data(rng, n=4, img=CANVAS, nk=20):
    images = np.full((n, img, img, 3), 40, np.uint8)
    boxes = np.zeros((n, 4), np.float32)
    kpts = np.zeros((n, nk, 3), np.float32)
    for i in range(n):
        w, h = rng.integers(14, 40, 2)
        x1, y1 = rng.integers(0, img - w), rng.integers(0, img - h)
        images[i, y1:y1 + h, x1:x1 + w] = 210
        boxes[i] = [x1, y1, x1 + w, y1 + h]
        kpts[i, :, 0] = x1 + rng.uniform(0, w, nk)
        kpts[i, :, 1] = y1 + rng.uniform(0, h, nk)
        kpts[i, :, 2] = rng.uniform(0, 1, nk) > 0.2
    return images, boxes, kpts


def test_pose_steps_match_jax():
    """Two ``train_pose_model`` steps (adamw(lr), ``pose_loss``), the JAX
    step built as its closure builds it."""
    images, boxes, kpts = _pose_data(np.random.default_rng(4))
    targets = tpt.assign_targets(boxes, kpts, CANVAS)
    want_t = jpt.assign_targets(boxes, kpts, CANVAS)
    assert set(targets) == set(want_t)
    for key in targets:
        np.testing.assert_array_equal(targets[key], want_t[key])
    model, jmodel, tree = _yolo_pair(1, 20, seed=2)
    x = images.astype(np.float32) / 255.0
    tx = optax.adamw(1e-3)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    state = tx.init(params)

    @jax.jit
    def step(p, o, xb, tb):
        (loss, aux), grads = jax.value_and_grad(
            lambda pp: jpt.pose_loss(jmodel, pp, xb, tb), has_aux=True)(p)
        updates, o = tx.update(grads, o, p)
        return optax.apply_updates(p, updates), o, loss, aux

    opt = Optimizer(model.parameters(), 1e-3)
    tt = {k: torch.from_numpy(v) for k, v in targets.items()}
    for rtol in LOSS_RTOL:
        params, state, loss, aux = step(params, state, jnp.asarray(x),
                                        {k: jnp.asarray(v)
                                         for k, v in targets.items()})
        got, parts = tpt.pose_loss(model, torch.from_numpy(x), tt)
        opt.step(got)
        if rtol == LOSS_RTOL[0]:
            _assert_grads({"m": model}, state)
        assert got.item() == pytest.approx(float(loss), rel=rtol)
        for key, val in aux.items():
            assert parts[key].item() == pytest.approx(float(val),
                                                      rel=rtol), key
    _assert_params(model, params, 1e-3)


def test_train_pose_model_restores_into_pose_engine(tmp_path):
    images, boxes, kpts = _pose_data(np.random.default_rng(5), n=4)
    report = tpt.train_pose_model(images, boxes, kpts, models_dir=tmp_path,
                                  epochs=2, batch_size=2, img_size=CANVAS,
                                  device="cpu")
    assert report["status"] == "completed"
    assert len(report["loss_history"]) == 2
    assert all(np.isfinite(report["loss_history"]))
    eng = make_test_engine(device="cpu")
    loaded = checkpoint.restore_engine(eng, tmp_path)
    assert loaded["pose"] and eng.loaded_weights["pose"]
    for key, val in report["params"].items():
        assert torch.equal(eng.pose_model.state_dict()[key], val), key


# ---------------------------------------------------------------------------
# the sequence heads
# ---------------------------------------------------------------------------
def _seq_batch(rng, b=4):
    x = rng.standard_normal((b, tseqf.TARGET_LEN, 44)).astype(np.float32)
    m = np.zeros((b, tseqf.TARGET_LEN), bool)
    m[:, :10] = True
    y = np.asarray([0, 1, 1, 0][:b], np.float32)
    return x, m, y


def test_heads_steps_match_jax():
    """``train_heads``' step with dropout 0 on both sides: joint BCE,
    clip_by_global_norm(1) + adamw(1e-3)."""
    x, m, y = _seq_batch(np.random.default_rng(6))
    jtcn, jgait = JTCN(input_dim=44, dropout=0.0), \
        JGait(input_dim=44, dropout=0.0)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    params = {"tcn": jtcn.init(k1, jnp.zeros((1, 125, 44))),
              "gait": jgait.init(k2, jnp.zeros((1, 125, 44)),
                                 jnp.zeros((1, 125), bool))}
    tcn, gait = TCN(input_dim=44, dropout=0.0, device="cpu"), \
        GaitTransformer(input_dim=44, dropout=0.0, device="cpu")
    sd = from_jax_params(_np_tree(params))
    tcn.load_state_dict(sd["tcn"])
    gait.load_state_dict(sd["gait"])
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(1e-3))
    state = tx.init(params)

    def loss_fn(p, key):
        ka, kb = jax.random.split(key)
        tp = jtcn.apply(p["tcn"], x, deterministic=False,
                        rngs={"dropout": ka})[:, 0]
        gp = jgait.apply(p["gait"], x, m, deterministic=False,
                         rngs={"dropout": kb})["probability"][:, 0]

        def bce(pr):
            pr = jnp.clip(pr, 1e-6, 1 - 1e-6)
            return -(y * jnp.log(pr) + (1 - y) * jnp.log(1 - pr)).mean()
        return bce(tp) + bce(gp)

    @jax.jit
    def step(p, o, key):
        loss, grads = jax.value_and_grad(loss_fn)(p, key)
        updates, o = tx.update(grads, o, p)
        return optax.apply_updates(p, updates), o, loss

    opt = Optimizer([*tcn.parameters(), *gait.parameters()], 1e-3,
                    max_norm=1.0)
    gen = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(1)
    for rtol in LOSS_RTOL:
        key, sub = jax.random.split(key)
        params, state, loss = step(params, state, sub)
        got, _ = tht.heads_loss(tcn, gait, *map(torch.from_numpy, (x, m, y)),
                                gen)
        opt.step(got)
        if rtol == LOSS_RTOL[0]:
            _assert_grads({"tcn": tcn, "gait": gait}, state)
        assert got.item() == pytest.approx(float(loss), rel=rtol)
    _assert_params(tcn, params["tcn"], 1e-3)
    _assert_params(gait, params["gait"], 1e-3)


def test_heads_dropout_spread_and_seeded():
    """Port only (torch and JAX draw different masks): the training forward
    spreads with dropout on, and a generator seed fixes it."""
    x, m, y = map(torch.from_numpy, _seq_batch(np.random.default_rng(7)))
    tcn, gait = TCN(device="cpu"), GaitTransformer(device="cpu")

    def losses(seed):
        gen = torch.Generator().manual_seed(seed)
        return torch.stack([tht.heads_loss(tcn, gait, x, m, y, gen)[0]
                            for _ in range(4)])
    a, b = losses(0), losses(0)
    assert torch.equal(a, b)
    assert float(a.std()) > 1e-4
    assert not torch.equal(a, losses(1))
    det = tht.heads_loss(tcn, gait, x, m, y, None)[0]
    assert torch.equal(det, tht.heads_loss(tcn, gait, x, m, y, None)[0])


def test_build_dataset_matches_jax(tmp_data_root):
    rng = np.random.default_rng(8)
    for i in range(5):
        _make_labeled_video(tmp_data_root.dirs, f"v{i}", i % 2, rng)
    want = jht.build_dataset(tmp_data_root.dirs)
    got = tht.build_dataset(tmp_data_root.dirs)
    assert set(got) == set(want)
    for key in ("features", "masks", "labels"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["video_ids"] == want["video_ids"]


def test_train_heads_checkpoints_and_restores(tmp_data_root):
    rng = np.random.default_rng(9)
    for i in range(6):
        _make_labeled_video(tmp_data_root.dirs, f"t{i}", i % 2, rng)
    models = tmp_data_root.dirs.models
    report = tht.train_heads(tmp_data_root.dirs, models, epochs=3,
                             batch_size=4, lr=3e-3, device="cpu")
    again = tht.train_heads(tmp_data_root.dirs, models / "again", epochs=3,
                            batch_size=4, lr=3e-3, device="cpu")
    assert report == again                      # seeded: dropout and order
    assert set(report) == {"status", "num_samples", "epochs_run",
                           "best_epoch", "best_loss", "final_loss",
                           "train_accuracy", "loss_history"}
    assert report["status"] == "completed" and report["num_samples"] == 6
    eng = make_test_engine(device="cpu")
    loaded = checkpoint.restore_engine(eng, models)
    assert loaded["tcn"] and loaded["gait"]
    saved = checkpoint.load_params(models, "tcn")
    for key, val in eng.tcn.state_dict().items():
        assert torch.equal(val, saved[key]), key
    empty = type(tmp_data_root.dirs)(root=str(tmp_data_root.dirs.root
                                              + "_empty"))
    assert tht.train_heads(empty, models, device="cpu")["status"] == "failed"


def test_sequence_features_match_jax(tmp_data_root):
    rng = np.random.default_rng(10)
    _make_labeled_video(tmp_data_root.dirs, "s", 1, rng)
    with open(tmp_data_root.dirs.results_for("tleap") / "s_tleap.json") as f:
        seqs = json.load(f)["pose_sequences"]
    seqs[3]["keypoints"] = seqs[3]["keypoints"][:7]      # short frame
    for length in (len(seqs), 140):
        rows = (seqs * 5)[:length]
        fw, mw = jseqf.extract_from_pose_sequences(rows)
        fg, mg = tseqf.extract_from_pose_sequences(rows)
        np.testing.assert_array_equal(fg, fw)
        np.testing.assert_array_equal(mg, mw)
        for a, b in zip(tseqf.pad_or_truncate(fg, mg),
                        jseqf.pad_or_truncate(fw, mw)):
            np.testing.assert_array_equal(a, b)
    assert tseqf.extract_from_pose_sequences([]) == (None, None)


# ---------------------------------------------------------------------------
# the graph heads
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def graph_set(tmp_path_factory):
    from lameness_tpu.core.config import Config
    cfg = Config.load(data_root=str(tmp_path_factory.mktemp("g") / "data"))
    cfg.dirs.ensure()
    _labeled_graph_data(cfg.dirs, np.random.default_rng(11), 8)
    return cfg.dirs


def test_build_graph_dataset_matches_jax(graph_set):
    want = jgt.build_graph_dataset(graph_set, max_nodes=16)
    got = tgt.build_graph_dataset(graph_set, max_nodes=16)
    assert set(got) == set(want)
    for key, val in want.items():
        if key == "video_ids":
            assert got[key] == val
        else:
            np.testing.assert_array_equal(got[key], val, err_msg=key)


@pytest.mark.parametrize("head", ["gnn", "graphormer"])
def test_graph_steps_match_jax(graph_set, head):
    """``train_graph_heads``' step at the serving widths: masked node BCE +
    0.2 graph BCE, clip_by_global_norm(0.5) + adamw(3e-4), deterministic."""
    g = jgt.build_graph_dataset(graph_set, max_nodes=16)
    if head == "gnn":
        jm, model = JGraphGPS(), EnhancedGraphGPS(device="cpu")
        jargs, targs = JRunner._gnn_args(g), on_device(gnn_inputs(g), "cpu")
        grad_atol = GRAD_ATOL
    else:
        jm, model = JGraphormer(), CowLamenessGraphormer(device="cpu")
        jargs, targs = JRunner._gt_args(g), on_device(gt_inputs(g), "cpu")
        grad_atol = 5e-4
    params = jax.jit(jm.init)(jax.random.PRNGKey(2), *jargs)
    model.load_state_dict(from_jax_params({"m": _np_tree(params)})["m"])
    y, lm = jnp.asarray(g["labels"]), \
        jnp.asarray(g["label_mask"].astype(np.float32))
    mean_label = float((g["labels"] * g["label_mask"]).sum()
                       / g["label_mask"].sum())
    tx = optax.chain(optax.clip_by_global_norm(0.5), optax.adamw(3e-4))
    state = tx.init(params)

    def loss_fn(p):
        out = jm.apply(p, *jargs)
        loss = jgt._bce(out["node_pred"][:, 0], y, lm)
        gp = out["graph_pred"].reshape(-1)[0]
        return loss + 0.2 * jgt._bce(gp, mean_label, 1.0)

    @jax.jit
    def step(p, o):
        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, o = tx.update(grads, o, p)
        return optax.apply_updates(p, updates), o, loss

    opt = Optimizer(model.parameters(), 3e-4, max_norm=0.5)
    ty, tlm = torch.from_numpy(np.asarray(y)), torch.from_numpy(np.asarray(lm))
    for rtol in LOSS_RTOL:
        params, state, loss = step(params, state)
        got = tgt.graph_loss(model, targs, ty, tlm, mean_label)
        opt.step(got)
        if rtol == LOSS_RTOL[0]:
            _assert_grads({"m": model}, state, grad_atol)
        assert got.item() == pytest.approx(float(loss), rel=rtol)
    _assert_params(model, params, 3e-4)


def test_train_graph_heads_end_to_end(graph_set, tmp_path):
    report = tgt.train_graph_heads(graph_set, tmp_path, epochs=3,
                                   device="cpu")
    assert report["status"] == "completed" and report["num_nodes"] == 8
    assert report["epochs_run"] == {"gnn": 3, "graphormer": 3}
    assert len(report["loss_history"]) == 6
    for name, cls in (("gnn", EnhancedGraphGPS),
                      ("graphormer", CowLamenessGraphormer)):
        model = cls(device="cpu")
        model.load_state_dict(checkpoint.load_params(tmp_path, name))


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------
def test_evaluate_detections_matches_jax():
    rng = np.random.default_rng(12)
    n, d, m = 5, 6, 3
    gt = rng.uniform(0, 50, (n, m, 2))
    gt = np.concatenate([gt, gt + rng.uniform(5, 30, (n, m, 2))], -1)
    pred = gt[:, rng.integers(0, m, d)] + rng.normal(0, 3, (n, d, 4))
    args = (pred, rng.uniform(0, 1, (n, d)), rng.integers(0, 2, (n, d)),
            rng.uniform(0, 1, (n, d)) > 0.2, gt, rng.integers(0, 2, (n, m)),
            rng.uniform(0, 1, (n, m)) > 0.1, 2)
    assert tev.evaluate_detections(*args) == jev.evaluate_detections(*args)
