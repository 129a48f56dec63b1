"""The port's mesh (``lameness_tpu_torch/parallel/mesh.py``, the engine's
``shard_inference``, ``process_stream``'s mesh branch and
``video/yuv.py``'s batch-major I420 rows) against the JAX package on the
CPU.

The engines are tests/test_torch_engine.py's tiny pair (the same seeded
weights, the heads with dropout 0), at 2 MC samples on both sides to keep
the CPU time down; the port's meshes repeat ``torch.device("cpu")``.  JAX's
sharded engine is ``slow`` on the CPU (tests/test_sharded_inference.py), so
the port's sharded engine is held to JAX's *unsharded* one, with
tests/test_torch_engine.py's gates (masks >= 99.5%, mask_iou_pred 1e-3,
integers equal, the rest 1e-4):

- dp 2 and dp 2 x tp 2 (DINO's blocks split over the model axis) on 2
  clips; dp 2 also over ``cpu`` and ``cpu:0``, which compare unequal, so
  the second replica holds copies of the modules as on a second card;
- padding: 1 clip over dp 2 (a zero clip fills the second shard and is
  trimmed), and 3 clips over dp 2;
- the ``yuv420`` transfer (the batch as I420 rows, each shard its block)
  against JAX on the frames round-tripped through I420;
- split ingest (a host dict) against JAX's split engine.

MC dropout over the data axis follows JAX's rule: a draw is a function of
the key and the global shape, so each data shard consumes its clips' rows
of the draws the unsharded engine makes at the same (padded) batch.  The
CPU's libraries round a clip's floats differently at another batch size,
so the reference (``parallel/same_batch.py`` ``same_batch``) is the
unsharded port engine run on each shard's clips alone and fed that
shard's rows of the whole batch's recorded draws.  Each dp-2 case above
(but dp x tp, whose DINO sums in another order) equals it bit for bit, at
dropout 0 and with the heads at dropout 0.2 and 0.1 (``mc``: the same
weights, so the masks count), and leaves the generator where the
whole-batch call leaves it; so do two identical clips (shard 1 must not
reuse shard 0's masks) over two calls in a row.  The shards' draws are
their rows of the whole batch's bit for bit
(``test_sharded_draws_are_the_unsharded_rows``).  The difference between
the reference and the unsharded engine at the whole batch is printed and
gates nothing.

Also: ``pack_i420_rows`` / ``i420_rows_to_rgb_device`` equal to JAX's
(bytes, layout, RGB); the layout helpers (``device_put``, ``Sharded.full``
and ``local``, the same tensor for the same device, ``pad_batch_to_multiple``
equal to JAX's, ``dino_tp_spec`` the transpose of JAX's for the port's
``(out, in)`` weights); ``warmup`` over the mesh; and ``process_stream``
over a dp-2 engine filling every batch to the data axis with the same
result files as the unsharded stream (1e-4).
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import jax

from lameness_tpu.parallel import mesh as jmesh
from lameness_tpu.pipeline import engine as jengine
from lameness_tpu.video import yuv as jyuv
from lameness_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS,
                                              NamedSharding, P, Sharded,
                                              device_put, dino_tp_spec,
                                              make_mesh,
                                              pad_batch_to_multiple,
                                              replica_groups,
                                              replicate_params,
                                              shard_params_tp)
from lameness_tpu_torch.parallel.same_batch import (RecordedDraws,
                                                    batch_difference,
                                                    differing_leaves,
                                                    same_batch,
                                                    shard_draws_are_rows)
from lameness_tpu_torch.pipeline.engine import EngineSpec
from lameness_tpu_torch.video import yuv as tyuv
from tests.test_torch_engine import (_assert_gates, _jax_engine, _leaves,
                                     _port_engine)

CPU = torch.device("cpu")
TINY = dict(clip_frames=15, frame_height=90, frame_width=160, fps=5,
            yolo_size=64, pose_size=64, dino_size=56, use_sam_model=True,
            sam_size=128, sam_mask_size=64)
MC = 2


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
    jeng.config = dataclasses.replace(jeng.config, tcn=dataclasses.replace(
        jeng.config.tcn, mc_samples=MC))
    jeng._build_jits()
    teng = _port_engine(jeng.params)
    teng.config = dataclasses.replace(teng.config, tcn=dataclasses.replace(
        teng.config.tcn, mc_samples=MC))
    return jeng, teng


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(0).integers(0, 256, (2, 15, 90, 160, 3),
                                             dtype=np.uint8)


@pytest.fixture(scope="module")
def want(engines, frames):
    return engines[0].process_clip_batch(frames)


def _gen():
    return torch.Generator().manual_seed(0)


def _sharded(teng, dp, tp=1):
    eng = teng.with_spec(teng.spec)
    eng.shard_inference(make_mesh(dp * tp, model_parallel=tp,
                                  devices=[CPU] * (dp * tp)))
    return eng


def _equal_trees(a, b):
    a, b = dict(_leaves(a)), dict(_leaves(b))
    assert set(a) == set(b)
    for key in a:
        assert a[key].dtype == b[key].dtype, key
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.fixture(scope="module")
def mc(engines):
    """The port engine with MC dropout on: the heads at rates 0.2 (TCN) and
    0.1 (GaitTransformer), the same weights."""
    from lameness_tpu_torch.models.gait_transformer import GaitTransformer
    from lameness_tpu_torch.models.tcn import TCN
    teng = engines[1]
    eng = teng.with_spec(teng.spec)
    eng.tcn = TCN(input_dim=44, dropout=0.2, device="cpu")
    eng.gait = GaitTransformer(input_dim=44, dropout=0.1, device="cpu")
    eng.load_state_dicts({"tcn": teng.tcn.state_dict(),
                          "gait": teng.gait.state_dict()})
    return eng


def _sharded_mc(mc, frames, generator, devices=(CPU, CPU), **kw):
    eng = mc.with_spec(mc.spec)
    eng.shard_inference(make_mesh(len(devices), devices=list(devices)))
    return eng.process_clip_batch(frames, generator, **kw)


def _same_batch_gate(teng, mc, frames, got0, devices=(CPU, CPU),
                     **kw) -> None:
    """``got0``, the sharded dropout-0 engine's outputs, bit for bit the
    unsharded ``teng`` on each shard's clips alone; the sharded ``mc``
    engine bit for bit the unsharded ``mc`` on each shard's clips alone
    fed their rows of the whole batch's draws, leaving the generator where
    the whole-batch call leaves it.  Prints the batch-size difference."""
    whole0, halves0, _ = same_batch(teng, frames, _gen(), 2, **kw)
    assert differing_leaves(got0, halves0) == []
    g_shard, g_one = _gen(), _gen()
    got = _sharded_mc(mc, frames, g_shard, devices, **kw)
    whole, halves, draws = same_batch(mc, frames, g_one, 2, **kw)
    assert draws
    assert differing_leaves(got, halves) == []
    assert torch.equal(g_shard.get_state(), g_one.get_state())
    print("batch-size difference, each shard's clips alone against the "
          f"whole batch: at dropout 0 {batch_difference(halves0, whole0)}, "
          f"at MC dropout {batch_difference(halves, whole)}")


# ---------------------------------------------------------------------------
# layouts and the I420 rows
# ---------------------------------------------------------------------------
def test_pack_i420_rows_matches_jax():
    rng = np.random.default_rng(7)
    tree = {"hi": tyuv.rgb_to_i420(rng.integers(0, 256, (4, 3, 32, 48, 3),
                                                dtype=np.uint8)),
            "lo": tyuv.rgb_to_i420(rng.integers(0, 256, (4, 5, 16, 24, 3),
                                                dtype=np.uint8))}
    for t in (tree, tree["hi"]):
        rows, layout = tyuv.pack_i420_rows(t)
        jrows, jlayout = jyuv.pack_i420_rows(t)
        assert layout == jlayout
        np.testing.assert_array_equal(rows, jrows)
        want = jyuv.i420_rows_to_rgb_device(jax.numpy.asarray(jrows),
                                            jlayout)
        # a block of rows (one data shard's) unpacks alone
        got = tyuv.i420_rows_to_rgb_device(torch.from_numpy(rows[2:]),
                                           layout)
        if isinstance(t, dict):
            for k in t:
                np.testing.assert_array_equal(got[k].numpy(),
                                              np.asarray(want[k])[2:])
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want)[2:])


def test_layout_helpers():
    mesh = make_mesh(4, model_parallel=2, devices=[CPU] * 4)
    assert mesh.shape == {DATA_AXIS: 2, MODEL_AXIS: 2}
    x = torch.arange(48.0).reshape(4, 12)
    for spec in (P(), P(DATA_AXIS), P(None, MODEL_AXIS),
                 P(MODEL_AXIS, DATA_AXIS), P((DATA_AXIS, MODEL_AXIS))):
        sh = device_put(x, NamedSharding(mesh, spec))
        assert torch.equal(sh.full(), x), spec
    sh = device_put(x, NamedSharding(mesh, P(MODEL_AXIS, DATA_AXIS)))
    assert sh.shards[1, 0].shape == (2, 6)
    assert torch.equal(sh.local((1, 0)), x[:2])        # gathered over data
    rep = device_put(x, NamedSharding(mesh, P()))
    assert all(t is x for t in rep.shards.flat)        # same device: no copy
    assert replica_groups({"x": rep}) == []
    tree = replicate_params(mesh, {"m": {"w": x}})
    assert isinstance(tree["m"]["w"], Sharded)
    with pytest.raises(ValueError, match="divide"):
        device_put(torch.zeros(3, 4), NamedSharding(mesh, P(DATA_AXIS)))
    a = np.arange(30, dtype=np.uint8).reshape(3, 10)
    for t in (a, {"hi": a, "lo": a[:, :4]}):
        got, b = pad_batch_to_multiple(t, 2)
        wt, wb = jmesh.pad_batch_to_multiple(t, 2)
        assert b == wb == 3
        _equal_trees(got if isinstance(got, dict) else {"": got},
                     wt if isinstance(wt, dict) else {"": wt})
    with pytest.raises(ValueError, match="given"):
        make_mesh(4, model_parallel=2, devices=[CPU] * 2)


def test_dino_tp_spec_is_jax_transposed(engines):
    """On the tiny DINO: a 2-D leaf's spec is JAX's on its flax kernel,
    transposed; a 1-D leaf's JAX's P(), but for a column-split layer's
    bias, split with its columns."""
    jeng, teng = engines
    specs = {}

    def note(path, leaf):
        specs["/".join(str(p.key) for p in path)] = tuple(
            jmesh.dino_tp_spec(path, leaf))
    jax.tree_util.tree_map_with_path(note, jeng.params["dino"]["params"])
    sd = teng.dino.state_dict()
    tp = shard_params_tp(make_mesh(2, model_parallel=2, devices=[CPU] * 2),
                         {"dino": sd})["dino"]
    checked = 0
    for key, leaf in sd.items():
        path = tuple(key.split("."))
        got = tuple(dino_tp_spec(path, leaf))
        assert tuple(tp[key].spec) == got
        jkey = "/".join(path[:-1] + ({"weight": "kernel"}.get(path[-1],
                                                              path[-1]),))
        if leaf.dim() == 2:
            assert got == tuple(reversed(specs[jkey])), key
            checked += got != ()
        elif leaf.dim() == 1 and jkey in specs:
            assert specs[jkey] == ()
            assert got in ((), (MODEL_AXIS,)), key
    assert checked == 2 * 6          # 2 blocks x (q, k, v, out, fc1, fc2)


# ---------------------------------------------------------------------------
# the sharded engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dp,tp", [(2, 1), (2, 2)])
def test_sharded_engine_matches_jax(engines, mc, frames, want, dp, tp):
    eng = _sharded(engines[1], dp, tp)
    got = eng.process_clip_batch_sharded(frames, _gen())
    _assert_gates(got, want)
    if tp == 1:
        _same_batch_gate(engines[1], mc, frames, got)


def test_sharded_engine_copies_match_jax(engines, mc, frames, want):
    """dp 2 over ``cpu`` and ``cpu:0``, devices that compare unequal: the
    second replica deep-copies the modules, as onto a second card, and
    still equals JAX by the gates and the unsharded port on each shard's
    clips alone bit for bit (MC dropout on, too, fed the whole batch's
    rows)."""
    eng = engines[1].with_spec(engines[1].spec)
    eng.shard_inference(make_mesh(2, devices=[CPU, torch.device("cpu", 0)]))
    second = eng._replicas[1]
    assert second.dino is not eng.dino and second.sam is not eng.sam
    got = eng.process_clip_batch_sharded(frames, _gen())
    _assert_gates(got, want)
    _same_batch_gate(engines[1], mc, frames, got,
                     (CPU, torch.device("cpu", 0)))


def test_sharded_engine_pads_and_trims(engines, mc, frames, want):
    eng = _sharded(engines[1], 2)
    got = eng.process_clip_batch(frames[:1], _gen())
    assert got["tcn_probability"].shape == (1,)
    _assert_gates(got, {k: v[:1] for k, v in dict(_leaves(want)).items()})
    dev = eng.to_device(frames[:1])
    assert dev.shape[0] == 2 and not dev.shards[1, 0].any()
    outs = eng.process_clip_batch(dev, _gen(), readback=False)
    assert len(outs) == 2        # one device tree a data shard, padding kept
    # 3 clips over dp 2: the second shard runs [clip 2, zero clip], and its
    # clip 2 is the unsharded engine's on that pair, bit for bit
    three = np.concatenate([frames, frames[:1]])
    got3 = dict(_leaves(eng.process_clip_batch(three, _gen())))
    pair = np.concatenate([frames[:1], np.zeros_like(frames[:1])])
    alone = dict(_leaves(engines[1].process_clip_batch(pair, _gen())))
    for key, v in got3.items():
        assert v.shape[0] == 3, key
        np.testing.assert_array_equal(v[2], alone[key][0], err_msg=key)
    # and with MC dropout, the batch padded to 4 with that zero clip
    _same_batch_gate(engines[1], mc, three, got3)


def test_sharded_yuv420_matches_jax(engines, mc, frames, monkeypatch):
    """The yuv420 transfer over the mesh: JAX on the round-tripped frames,
    and the unsharded port's yuv420 run on each shard's clips alone bit
    for bit (MC dropout on, too, fed the whole batch's rows)."""
    jeng, teng = engines
    trip = tyuv.i420_to_rgb_device(torch.from_numpy(
        tyuv.rgb_to_i420(frames))).numpy()
    monkeypatch.setenv("LAMENESS_YUV_INGEST", "1")
    got = _sharded(teng, 2).process_clip_batch(frames, _gen())
    _assert_gates(got, jeng.process_clip_batch(trip, transfer="rgb"))
    _same_batch_gate(teng, mc, frames, got, transfer="yuv420")


def test_sharded_split_ingest_matches_jax(engines, frames):
    jeng, teng = engines
    split = dict(TINY, lo_height=46, lo_width=80)
    jspec = jengine.EngineSpec(**split)
    host = jspec.split_pack_host(frames)
    want = jeng.with_spec(jspec).process_clip_batch(host)
    eng = teng.with_spec(EngineSpec(**split))
    eng.shard_inference(make_mesh(2, devices=[CPU] * 2))
    got = eng.process_clip_batch(host, _gen())
    _assert_gates(got, want)
    # the I420 rows of a split dict: hi and lo in each clip's row
    dev = eng.to_device(host, transfer="yuv420")
    assert set(dev) == {"hi", "lo"} and dev["lo"].shape[0] == 2


def test_sharded_mc_dropout_is_the_unsharded_batch(mc, frames):
    """Two identical clips over dp 2 with MC dropout on: the unsharded
    engine gives them different masks (rows 0 and 1 of each sample's
    draw), and so must the shards, each its clip's rows of the whole
    batch's draws, bit for bit, over two calls in a row with one generator,
    which ends where the unsharded calls leave it."""
    twins = np.concatenate([frames[:1], frames[:1]])
    eng = mc.with_spec(mc.spec)
    eng.shard_inference(make_mesh(2, devices=[CPU] * 2))
    g_shard, g_one = _gen(), _gen()
    for _ in range(2):
        got = eng.process_clip_batch(twins, g_shard)
        whole, halves, _ = same_batch(mc, twins, g_one, 2)
        for ref in (whole, halves):
            assert np.abs(ref["tcn_uncertainty"][0]
                          - ref["tcn_uncertainty"][1]).max() > 1e-4
        assert differing_leaves(got, halves) == []
        assert torch.equal(g_shard.get_state(), g_one.get_state())


def test_sharded_draws_are_the_unsharded_rows(mc, frames, monkeypatch):
    """Each shard's dropout draws, site by site, are its clips' rows of
    every MC sample's block of the unsharded engine's draw at the same
    batch (4 clips over dp 2, 2 samples), bit for bit."""
    from lameness_tpu_torch.pipeline.train import RowDraws
    four = np.concatenate([frames, frames[::-1]])
    whole = RecordedDraws(_gen())
    mc.process_clip_batch(four, whole)
    shard_draws = []
    rand = RowDraws.rand

    def spy(self, shape, device):
        u = rand(self, shape, device)
        assert self.groups == MC
        shard_draws.append((self.lo, self.hi, u))
        return u
    monkeypatch.setattr(RowDraws, "rand", spy)
    _sharded_mc(mc, four, _gen())
    assert shard_draws_are_rows(whole.draws, shard_draws, 4, 2)


def test_sharded_warmup(engines):
    eng = _sharded(engines[1], 2)
    assert set(eng.warmup(batch=1)) == {"detect", "sam", "dino", "heads"}


# ---------------------------------------------------------------------------
# the stream
# ---------------------------------------------------------------------------
def test_process_stream_fills_batches_to_the_data_axis(engines, tmp_path):
    """Three clips at batch_size=1 over dp 2: engine calls of 2 clips (the
    last filled with the third clip again), the same result files as the
    unsharded stream at batch_size=2 (1e-4)."""
    from lameness_tpu.video.decode import VideoReader
    from lameness_tpu_torch.core import config as tconfig
    from lameness_tpu_torch.serve.driver import PipelineDriver
    from tests.test_torch_serve import KINDS, _clips, _flat_json
    teng = engines[1]
    jobs = _clips(tmp_path)
    sharded = _sharded(teng, 2)
    sizes = []
    run = sharded.run_sharded

    def spy(frames_dev, *args, **kw):
        sizes.append(frames_dev.shape[0])
        return run(frames_dev, *args, **kw)
    sharded.run_sharded = spy
    drivers = []
    for name, eng, bs in (("mesh", sharded, 1), ("one", teng, 2)):
        cfg = tconfig.Config(dirs=tconfig.DataDirs(root=str(tmp_path / name)))
        drv = PipelineDriver(config=cfg, engine=eng, reader=VideoReader)
        assert len(drv.process_stream(jobs, batch_size=bs,
                                      decode_workers=2)) == 3
        drivers.append(drv)
    assert sizes == [2, 2]
    for vid, _ in jobs:
        for kind in KINDS:
            got, want = (dict(_flat_json(json.loads(
                (d.dirs.results_for(kind) / f"{vid}_{kind}.json")
                .read_text()))) for d in drivers)
            assert list(got) == list(want), (vid, kind)
            for key, w in want.items():
                if isinstance(w, float):
                    np.testing.assert_allclose(got[key], w, atol=1e-4,
                                               rtol=0, err_msg=key)
                else:
                    assert got[key] == w, (vid, kind, key)
