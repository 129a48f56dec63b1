"""The port's graph heads (``lameness_tpu_torch/graph``, ``models/graphgps.py``,
``models/graphormer.py``, ``serve/graph_runner.py``) against the JAX package
on the CPU.

- ``graph/build.py``: every function bit for bit on seeded graphs.
- GraphGPS and Graphormer, deterministic, at the runner's widths (128-d, 8
  heads; 4 and 6 layers) and ``max_nodes`` 16, with the JAX runner's
  ``PRNGKey(0)`` weights carried across by ``weights.from_jax_params``:
  every output within 1e-5; the port's outputs on the valid nodes do not
  move when the padding grows.
- The converter's two shapes added for the heads: Graphormer's
  ``DenseGeneral((heads, hd))`` q/k/v and the InferenceBN leaves.
- ``GraphHeadRunner.process_video`` with dropout-0 heads on both sides,
  per-cow and global graphs: the two result files' numbers within 1e-5,
  ids, neighbour lists and orders equal.
- MC-dropout (port only): the samples spread, a video's files are the same
  on every run, and two videos draw different masks.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from lameness_tpu.graph import build as jgb
from lameness_tpu.models.graphgps import EnhancedGraphGPS as JGraphGPS
from lameness_tpu.models.graphormer import CowLamenessGraphormer as JGraphormer
from lameness_tpu.serve.graph_runner import GraphHeadRunner as JRunner
from lameness_tpu_torch.core.config import Config, DataDirs
from lameness_tpu_torch.graph import build as tgb
from lameness_tpu_torch.models.graphgps import EnhancedGraphGPS
from lameness_tpu_torch.models.graphormer import CowLamenessGraphormer
from lameness_tpu_torch.serve.graph_runner import GraphHeadRunner
from lameness_tpu_torch.weights import from_jax_params

ATOL = 1e-5
N_PAD = 16


def _graph_inputs(seed, n=11, n_pad=N_PAD, build=tgb):
    rng = np.random.default_rng(seed)
    g = build.build_dense_graph(
        rng.standard_normal((n, 50)).astype(np.float32),
        rng.standard_normal((n, 32)).astype(np.float32),
        video_ids=[f"v{i}" for i in range(n)],
        cow_ids=[f"c{i % 3}" if i % 4 else None for i in range(n)],
        timestamps=list(1.7e9 + rng.uniform(0, 3e6, n)), max_nodes=n_pad)
    g["x"] = build.standardize_features(g["x"], g["node_mask"])
    em, nm = g["edge_mask"], g["node_mask"]
    gnn = (g["x"], build.laplacian_pe(em, nm, 8),
           build.random_walk_pe(em, nm, 16), g["edge_attr"], em, nm)
    din, dout = build.degrees(em, nm)
    gt = (g["x"], build.shortest_path_dense(em, nm, 10), g["edge_attr"], em,
          din, dout, g["timestamps"], nm)
    return g, gnn, gt


# ---------------------------------------------------------------------------
# graph/build.py
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_build_functions_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 14))
    embs = rng.standard_normal((n, 32)).astype(np.float32)
    mask = np.zeros(16, bool)
    mask[:n] = True
    pad = np.zeros((16, 32), np.float32)
    pad[:n] = embs
    for a, b in zip(tgb.knn_edges_dense(pad, mask, 5),
                    jgb.knn_edges_dense(pad, mask, 5)):
        np.testing.assert_array_equal(a, b)
    cows = [f"c{i % 3}" if i % 5 else None for i in range(16)]
    ts = list(rng.uniform(0, 1e6, 16))
    for a, b in zip(tgb.temporal_edges_dense(cows, ts, mask),
                    jgb.temporal_edges_dense(cows, ts, mask)):
        np.testing.assert_array_equal(a, b)
    gt_, gnn_t, gtr_t = _graph_inputs(seed, n=n, build=tgb)
    gj, gnn_j, gtr_j = _graph_inputs(seed, n=n, build=jgb)
    for key in gj:
        np.testing.assert_array_equal(gt_[key], gj[key])
    for a, b in zip(gnn_t + gtr_t, gnn_j + gtr_j):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the heads
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def heads():
    """Both heads' JAX modules and PRNGKey(0) parameters (the JAX runner's
    initialisation), and the port's modules with them loaded."""
    _, gnn, gt = _graph_inputs(0)
    jg, jt = JGraphGPS(), JGraphormer()
    key = jax.random.PRNGKey(0)
    pg = jax.jit(jg.init)(key, *map(jnp.asarray, gnn))
    pt = jax.jit(jt.init)(key, *map(jnp.asarray, gt))
    sd = from_jax_params({"gnn": pg, "gt": pt})
    tg, tt = EnhancedGraphGPS(device="cpu"), CowLamenessGraphormer(
        device="cpu")
    tg.load_state_dict(sd["gnn"])
    tt.load_state_dict(sd["gt"])
    return {"gnn": (jg, pg, tg.eval()), "gt": (jt, pt, tt.eval())}


def _torch(args):
    return [torch.from_numpy(np.asarray(a)) for a in args]


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("head", ["gnn", "gt"])
def test_head_matches_jax(heads, head, seed):
    jm, params, tm = heads[head]
    _, gnn, gt = _graph_inputs(seed)
    args = gnn if head == "gnn" else gt
    want = jm.apply(params, *map(jnp.asarray, args))
    with torch.no_grad():
        got = tm(*_torch(args))
    assert set(got) == set(want)
    for key, w in want.items():
        np.testing.assert_allclose(got[key][0].numpy(), np.asarray(w),
                                   atol=ATOL, rtol=0, err_msg=key)


@pytest.mark.parametrize("head", ["gnn", "gt"])
def test_head_padding_invariance(heads, head):
    """The valid nodes' outputs do not move when the padding grows."""
    tm = heads[head][2]
    outs = []
    for n_pad in (N_PAD, 24):
        _, gnn, gt = _graph_inputs(4, n_pad=n_pad)
        with torch.no_grad():
            outs.append(tm(*_torch(gnn if head == "gnn" else gt)))
    a, b = outs
    n = 11
    np.testing.assert_allclose(b["graph_pred"], a["graph_pred"], atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(b["node_pred"][:, :n], a["node_pred"][:, :n],
                               atol=ATOL, rtol=0)
    if head == "gnn":
        np.testing.assert_allclose(b["attention_weights"][:, :n],
                                   a["attention_weights"][:, :n],
                                   atol=ATOL, rtol=0)
    else:
        np.testing.assert_allclose(b["attention_weights"][..., :n, :n],
                                   a["attention_weights"][..., :n, :n],
                                   atol=ATOL, rtol=0)


def test_converter_dense_general_heads_and_bn_leaves(heads):
    """Graphormer's q/k/v kernels (in, H, hd) with (H, hd) biases become
    Linear(in, H·hd); the output kernel (H, hd, out) keeps its branch; the
    InferenceBN leaves carry over under their own names."""
    pt = heads["gt"][1]["params"]
    q = pt["layer0"]["attn"]["q"]
    out = pt["layer0"]["attn"]["out"]
    assert q["kernel"].ndim == 3 and q["bias"].ndim == 2
    sd = from_jax_params({"gt": heads["gt"][1]})["gt"]
    k = np.asarray(q["kernel"])
    np.testing.assert_array_equal(sd["layer0.attn.q.weight"].numpy(),
                                  k.reshape(k.shape[0], -1).T)
    np.testing.assert_array_equal(sd["layer0.attn.q.bias"].numpy(),
                                  np.asarray(q["bias"]).reshape(-1))
    ko = np.asarray(out["kernel"])
    np.testing.assert_array_equal(sd["layer0.attn.out.weight"].numpy(),
                                  ko.reshape(-1, ko.shape[-1]).T)
    bn = heads["gnn"][1]["params"]["pre0"]["local"]["bn_node"]
    assert set(bn) == {"scale", "bias", "mean", "var"}
    sdg = from_jax_params({"gnn": heads["gnn"][1]})["gnn"]
    for leaf in ("scale", "bias", "mean", "var"):
        np.testing.assert_array_equal(
            sdg[f"pre0.local.bn_node.{leaf}"].numpy(), np.asarray(bn[leaf]))
    # strict load: every leaf has a home
    EnhancedGraphGPS(device="cpu").load_state_dict(sdg)
    CowLamenessGraphormer(device="cpu").load_state_dict(sd)


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------
def _flat(obj, prefix=""):
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from _flat(v, f"{prefix}.{k}")
    elif isinstance(obj, list):
        yield prefix + "#len", len(obj)
        for i, v in enumerate(obj):
            yield from _flat(v, f"{prefix}[{i}]")
    else:
        yield prefix, obj


def assert_json_close(got, want, atol=ATOL):
    g, w = dict(_flat(got)), dict(_flat(want))
    assert list(g) == list(w)
    for key, x in w.items():
        if isinstance(x, float):
            assert abs(g[key] - x) <= atol, (key, g[key], x)
        else:
            assert g[key] == x, (key, g[key], x)


@pytest.fixture(scope="module")
def cow_root(tmp_path_factory):
    """4 cows x 3 videos with tracking files, and one video without."""
    root = tmp_path_factory.mktemp("graph")
    vids = chip_smoke.write_cow_videos(root, cows=4, per_cow=3, dim=64)
    (root / "results" / "tracking" / f"{vids[-1]}_tracking.json").unlink()
    return root, vids


@pytest.fixture(scope="module")
def runners(cow_root):
    """The JAX runner and the port's with dropout-0 heads and the JAX
    runner's weights."""
    from lameness_tpu.core.config import Config as JConfig
    from lameness_tpu.core.config import DataDirs as JDataDirs
    root, vids = cow_root
    jrun = JRunner(JConfig(dirs=JDataDirs(root=str(root))), max_nodes=N_PAD)
    jrun.gnn, jrun.gt = JGraphGPS(dropout=0.0), JGraphormer(dropout=0.0)
    jrun._ensure_params(N_PAD)
    params = from_jax_params({"gnn": jrun._params["gnn"],
                              "gt": jrun._params["gt"]})
    trun = chip_smoke.zero_dropout(GraphHeadRunner(
        Config(dirs=DataDirs(root=str(root))), max_nodes=N_PAD, device="cpu",
        params=params))
    return jrun, trun


@pytest.mark.parametrize("which", ["per_cow", "global"])
def test_runner_matches_jax(cow_root, runners, which):
    root, vids = cow_root
    jrun, trun = runners
    target = vids[4] if which == "per_cow" else vids[-1]
    want = jrun.process_video(target)
    got = trun.process_video(target)
    assert got["gnn"]["graph_info"]["per_cow_graph"] == (which == "per_cow")
    n = got["gnn"]["graph_info"]["num_nodes"]
    assert n == (3 if which == "per_cow" else len(vids))
    for kind in ("gnn", "graph_transformer"):
        assert_json_close(got[kind], want[kind])
        on_disk = json.loads((root / "results" / kind
                              / f"{target}_{kind}.json").read_text())
        assert on_disk == got[kind]


def test_runner_node_cap_keeps_target(cow_root, runners):
    root, vids = cow_root
    trun = runners[1]
    small = GraphHeadRunner(trun.config, max_nodes=4, device="cpu",
                            params={"gnn": trun.gnn.state_dict(),
                                    "gt": trun.gt.state_dict()})
    ids = small.collect_graph(vids[0])[0]
    assert ids[-1] == vids[0] and len(ids) <= 4
    ids = small.collect_graph(vids[-1])[0]        # global: capped at 4
    assert len(ids) == 4 and ids[-1] == vids[-1]


def test_mc_dropout_spread_and_reproducible(cow_root, tmp_path):
    """Port only: torch and JAX draw different masks (ROADMAP §3)."""
    root, vids = cow_root
    cfg = Config(dirs=DataDirs(root=str(root)))
    a = GraphHeadRunner(cfg, max_nodes=N_PAD, device="cpu")
    b = GraphHeadRunner(cfg, max_nodes=N_PAD, device="cpu")
    first = a.process_video(vids[1])
    assert first == b.process_video(vids[1])
    assert first["gnn"]["uncertainty"] > 0
    assert first["graph_transformer"]["uncertainty"] > 0
    # the deterministic outputs need no generator
    assert first["gnn"]["cow_severity_score"] == \
        b.process_video(vids[1])["gnn"]["cow_severity_score"]
    # another video id seeds other masks
    other = a.process_video(vids[2])
    assert other["gnn"]["uncertainty"] != first["gnn"]["uncertainty"]
    # the seeded weights are the same in every runner
    for x, y in zip(a.gt.state_dict().values(), b.gt.state_dict().values()):
        assert torch.equal(x, y)


def test_runner_needs_cuda_unless_cpu(cow_root, monkeypatch):
    from lameness_tpu_torch.serve.driver import PipelineDriver
    root, _ = cow_root
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config(dirs=DataDirs(root=str(root)))
    with pytest.raises(RuntimeError, match="CUDA"):
        GraphHeadRunner(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        PipelineDriver(config=cfg)._ensure_graph_runner()
    assert GraphHeadRunner(cfg, device="cpu").device.type == "cpu"
