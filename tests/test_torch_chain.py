"""The port's upload -> analysis chain (``PipelineDriver.ingest``,
``preprocess``, ``process_video_file``, ``Config.load`` and the ``process``
subcommand) against the JAX package on the CPU.

Both drivers take the same ``.y4m`` upload; the JAX side reads and writes
through the cvtColor Y4M pair of tests/test_torch_decode.py, so both see
the same pixels.  The engines are tests/test_torch_engine.py's tiny ones
(dropout 0, the JAX weights carried over by ``weights.from_jax_params``) at
the geometry of the crop, so the engine reads the crop's frames unresized
on both sides; the graph heads run the JAX runner's weights at dropout 0.

- ``ingest``: the same copy and message.
- ``preprocess``: the same crop box and the same cropped ``.y4m`` bytes,
  from curation's memo and frame cache, and with a detector and no cache.
- ``process_video_file`` with the motion fallback and with a square
  detector: the quality report as in tests/test_torch_curation.py, the
  canonical clip's frames and size, the six stage files within PERF.md
  §2's 1e-4 (these runs' masks are equal), the analysis files (tracking,
  graph heads, ML, fusion, cow prediction) within 1e-4 and their
  timestamps apart, and the same bus subjects in the same order.
"""
import dataclasses
import itertools
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from lameness_tpu.core import config as jconfig
from lameness_tpu.serve.driver import PipelineDriver as JDriver
from lameness_tpu.track import reid as jreid
from lameness_tpu.video import curation as jcur
from lameness_tpu_torch.core import config as tconfig
from lameness_tpu_torch.io import schemas as tschemas
from lameness_tpu_torch.serve.driver import PipelineDriver
from lameness_tpu_torch.video import curation as tcur
from lameness_tpu_torch.video.decode import VideoReader, write_video
from test_torch_curation import (assert_same_report, synthetic_walk_frames,
                                 textured_walk)
from test_torch_decode import swap_jax_io
from test_torch_graph import N_PAD

ROOT = Path(__file__).resolve().parents[1]
STAGES = ("yolo", "sam3", "dinov3", "tleap", "tcn", "transformer")
ANALYSIS = ("tracking", "gnn", "graph_transformer", "ml", "fusion")
ATOL = 1e-4
# keys that hold the wall clock or a path under each side's own root
STAMPS = ("timestamp", "last_updated", "uploaded_at")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module: its tests run many small tensor
    ops (MOG2 a frame at a time), and a pool of threads per op crawls when
    the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _upload(tmp_path, kind):
    if kind == "motion":
        frames = textured_walk(n=80)
    else:
        frames = synthetic_walk_frames(n_frames=70, w=320, h=90, fps=10,
                                       size=30)
    return write_video(tmp_path / "upload", list(frames), 10, device="cpu")


def _curators(kind, jcfg, tcfg):
    """None each for the drivers' own (the motion fallback), or the square
    detector injected on both sides."""
    if kind == "motion":
        return None, None
    from tests.test_video import _square_detector
    return (jcur.ClipCurator(jcfg.dirs, detector=_square_detector),
            tcur.ClipCurator(tcfg.dirs, detector=_square_detector,
                             device="cpu"))


def _configs(root):
    return (jconfig.Config.load(data_root=str(root / "jax")),
            tconfig.Config(dirs=tconfig.DataDirs(root=str(root / "port"))))


def _crop_geometry(tmp_path, src, kind, monkeypatch):
    """The JAX driver's crop of ``src`` (no engine needed): (h, w)."""
    jcfg, _ = _configs(tmp_path / "dry")
    jc, _ = _curators(kind, jcfg, jcfg)
    drv = JDriver(config=jcfg, curator=jc)
    vid = drv.ingest(src, "vid")
    drv.curator.curate_video(next(drv.dirs.videos.glob("vid.*")), vid)
    x1, y1, x2, y2 = drv.preprocess(vid)["crop_box"]
    drv.bus.shutdown()
    return y2 - y1, x2 - x1


def _engines(h, w):
    from tests.test_torch_engine import _jax_engine, _port_engine
    jeng = _jax_engine()
    jeng.spec = dataclasses.replace(jeng.spec, frame_height=h,
                                    frame_width=w)
    jeng._build_jits()
    teng = _port_engine(jeng.params)
    teng = teng.with_spec(dataclasses.replace(teng.spec, frame_height=h,
                                              frame_width=w))
    return jeng, teng


def _graph_runners(jdrv, tdrv):
    """The JAX runner (dropout 0, its PRNGKey(0) weights) and the port's
    with those weights."""
    from lameness_tpu.models.graphgps import EnhancedGraphGPS as JGraphGPS
    from lameness_tpu.models.graphormer import \
        CowLamenessGraphormer as JGraphormer
    from lameness_tpu.serve.graph_runner import GraphHeadRunner as JRunner
    from lameness_tpu_torch.serve.graph_runner import GraphHeadRunner
    from lameness_tpu_torch.weights import from_jax_params
    jr = JRunner(jdrv.config, bus=jdrv.bus, max_nodes=N_PAD)
    jr.gnn = JGraphGPS(dropout=0.0)
    jr.gt = JGraphormer(dropout=0.0)
    jr._ensure_params(N_PAD)
    params = from_jax_params({"gnn": jr._params["gnn"],
                              "gt": jr._params["gt"]})
    jdrv.graph_runner = jr
    tdrv.graph_runner = chip_smoke.zero_dropout(GraphHeadRunner(
        tdrv.config, bus=tdrv.bus, max_nodes=N_PAD, device="cpu",
        params=params))


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


def _same_json(got, want, name):
    g, w = dict(_flat(got)), dict(_flat(want))
    assert list(g) == list(w), name
    for key, x in w.items():
        if key.rsplit(".", 1)[-1] in STAMPS:
            continue
        y = g[key]
        if isinstance(x, float) or isinstance(y, float):
            assert abs(y - x) <= ATOL, (name, key, y, x)
        elif isinstance(x, str) and x.startswith("/"):    # a path
            assert Path(y).name == Path(x).name.replace(".mp4", ".y4m"), \
                (name, key)
        else:
            assert y == x, (name, key, y, x)


@pytest.fixture()
def counted_uuids(monkeypatch):
    """Re-ID's identity ids from a counter, restarted for each driver."""
    counter = [itertools.count()]
    monkeypatch.setattr(jreid.uuid, "uuid4",
                        lambda: f"id-{next(counter[0])}")
    return counter


@pytest.mark.parametrize("kind", ["motion", "square"])
def test_process_video_file_matches_jax(tmp_path, monkeypatch,
                                        counted_uuids, kind):
    swap_jax_io(monkeypatch)
    src = _upload(tmp_path, kind)
    h, w = _crop_geometry(tmp_path, src, kind, monkeypatch)
    jeng, teng = _engines(h, w)
    jcfg, tcfg = _configs(tmp_path)
    jc, tc = _curators(kind, jcfg, tcfg)
    jdrv = JDriver(config=jcfg, engine=jeng, curator=jc)
    tdrv = PipelineDriver(config=tcfg, engine=teng, curator=tc)
    _graph_runners(jdrv, tdrv)
    out = {}
    for tag, drv in (("jax", jdrv), ("port", tdrv)):
        counted_uuids[0] = itertools.count()
        out[tag] = drv.process_video_file(src, "vid")
        drv.bus.shutdown()
    if kind == "motion":
        assert isinstance(tdrv.curator.detector, tcur.MotionDetector)
    roots = {tag: Path(d.dirs.root) for tag, d in (("jax", jdrv),
                                                    ("port", tdrv))}
    got = json.loads((roots["port"] / "quality_reports"
                      / "vid_quality.json").read_text())
    want = json.loads((roots["jax"] / "quality_reports"
                       / "vid_quality.json").read_text())
    assert_same_report(got, want)
    assert got["status"] == "success"
    # the crop and the canonical clip (a side output)
    assert (roots["port"] / "processed" / "vid_cropped.y4m").read_bytes() \
        == (roots["jax"] / "processed" / "vid_cropped.y4m").read_bytes()
    a, b = (VideoReader(r / "canonical" / "vid_canonical.y4m",
                        device="cpu").read_sampled()[0]
            for r in (roots["jax"], roots["port"]))
    assert a.shape == b.shape
    assert (np.maximum(a, b) - np.minimum(a, b)).max() <= 4
    names = sorted(p.relative_to(roots["jax"]).as_posix()
                   for p in (roots["jax"] / "results").glob("*/*.json"))
    assert names == sorted(
        p.relative_to(roots["port"]).as_posix()
        for p in (roots["port"] / "results").glob("*/*.json"))
    assert {n.split("/")[1] for n in names} >= set(STAGES + ANALYSIS)
    for name in names:
        g = json.loads((roots["port"] / name).read_text())
        w_ = json.loads((roots["jax"] / name).read_text())
        kind_ = name.split("/")[1]
        if kind_ in STAGES + ANALYSIS:
            assert tschemas.validate(kind_, g) == []
        _same_json(g, w_, name)
    yolo = json.loads((roots["port"] / "results/yolo/vid_yolo.json"
                       ).read_text())
    assert yolo["detections"], "no detection: the comparison is idle"
    _same_json(out["port"]["fusion"], out["jax"]["fusion"], "fusion")
    assert [m["subject"] for m in tdrv.bus.history] == \
        [m["subject"] for m in jdrv.bus.history]
    for m_t, m_j in zip(tdrv.bus.history, jdrv.bus.history):
        _same_json(m_t["payload"], m_j["payload"], m_j["subject"])


def test_ingest_matches_jax(tmp_path):
    src = write_video(tmp_path / "up", list(textured_walk(n=4)), 10,
                      device="cpu")
    jcfg, tcfg = _configs(tmp_path)
    jdrv, tdrv = JDriver(config=jcfg), PipelineDriver(config=tcfg,
                                                      device="cpu")
    for drv in (jdrv, tdrv):
        assert drv.ingest(src, "v1") == "v1"
        assert len(drv.ingest(src)) == 36                  # a uuid4
        drv.bus.shutdown()
    for tag, drv in (("jax", jdrv), ("port", tdrv)):
        assert (drv.dirs.videos / "v1.y4m").read_bytes() == src.read_bytes()
    (mj, mt) = (d.bus.history[0] for d in (jdrv, tdrv))
    assert mt["subject"] == mj["subject"] == "video.uploaded"
    _same_json(mt["payload"], mj["payload"], "video.uploaded")


@pytest.mark.parametrize("memo", [True, False], ids=["memo", "detector"])
def test_preprocess_matches_jax(tmp_path, monkeypatch, memo):
    """The crop box and the cropped clip: from curation's memo and frame
    cache, or with a detector given and the cache off (a decode of the
    raw upload)."""
    from tests.test_video import _square_detector
    swap_jax_io(monkeypatch)
    if not memo:
        monkeypatch.setenv("LAMENESS_FRAME_CACHE_MB", "0")
    src = _upload(tmp_path, "square")
    jcfg, tcfg = _configs(tmp_path)
    jc, tc = _curators("square", jcfg, tcfg)
    jdrv = JDriver(config=jcfg, curator=jc)
    tdrv = PipelineDriver(config=tcfg, curator=tc, device="cpu")
    pre = {}
    for tag, drv in (("jax", jdrv), ("port", tdrv)):
        drv.ingest(src, "vid")
        drv.curator.curate_video(next(drv.dirs.videos.glob("vid.*")), "vid")
        pre[tag] = drv.preprocess(
            "vid", detector=None if memo else _square_detector)
        drv.bus.shutdown()
    assert pre["port"]["crop_box"] == pre["jax"]["crop_box"]
    assert pre["port"]["fps"] == pre["jax"]["fps"] == 10
    x1, y1, x2, y2 = pre["port"]["crop_box"]
    assert (x2 - x1) % 2 == 0 and (y2 - y1) % 2 == 0 and x2 - x1 < 320
    path = Path(pre["port"]["processed_path"])
    assert path.name == "vid_cropped.y4m"
    assert path.read_bytes() == (jdrv.dirs.processed
                                 / "vid_cropped.y4m").read_bytes()
    assert tdrv.curator._frame_cache is None       # popped, or never kept
    assert tdrv.preprocess("missing") is None


def test_config_load_matches_jax(tmp_path, monkeypatch):
    yml = tmp_path / "config.yaml"
    yml.write_text("models:\n  yolo:\n    confidence_threshold: 0.7\n"
                   f"data:\n  videos_dir: {tmp_path}/store/videos\n")
    monkeypatch.delenv("DATABASE_URL", raising=False)
    for kw in ({}, {"data_root": str(tmp_path / "d")}, {"path": str(yml)},
               {"path": str(tmp_path / "absent.yaml")}):
        for env in (None, str(tmp_path / "env")):
            if env is None:
                monkeypatch.delenv("LAMENESS_DATA_ROOT", raising=False)
            else:
                monkeypatch.setenv("LAMENESS_DATA_ROOT", env)
            j, t = jconfig.Config.load(**kw), tconfig.Config.load(**kw)
            assert t.dirs.root == j.dirs.root
            assert t.yolo.confidence_threshold == \
                j.yolo.confidence_threshold
    assert tconfig.Config.load(path=str(yml)).yolo.confidence_threshold \
        == 0.7
    assert dataclasses.asdict(tconfig.CurationConfig()) == \
        dataclasses.asdict(jconfig.CurationConfig())
    assert tconfig.CurationConfig().clip_frames == 125
    # yaml is read only when a file is given (not a dependency of the port)
    code = ("import sys; from lameness_tpu_torch.core.config import Config; "
            "Config.load(); print('yaml' in sys.modules)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.stdout.strip() == "False", res.stderr


@pytest.mark.parametrize("env", [
    {}, {"LAMENESS_SAM_RECT": "1"}, {"LAMENESS_POSE_PIXELS": "0"},
    {"LAMENESS_INGEST": "1024x576"},
    {"LAMENESS_INGEST": "1024x576+640x360", "LAMENESS_POSE_PIXELS": "1"}])
def test_ingest_spec_matches_jax(tmp_path, monkeypatch, env):
    from lameness_tpu.__main__ import ingest_spec as jspec
    from lameness_tpu_torch.__main__ import ingest_spec as tspec
    for key in ("LAMENESS_SAM_RECT", "LAMENESS_POSE_PIXELS",
                "LAMENESS_INGEST"):
        monkeypatch.delenv(key, raising=False)
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    jcfg, tcfg = _configs(tmp_path)
    for cfgs in ((None, None), (jcfg, tcfg)):
        j, t = jspec(cfgs[0]), tspec(cfgs[1])
        for f in ("frame_height", "frame_width", "lo_height", "lo_width",
                  "sam_rect", "pose_pixels", "clip_frames"):
            assert getattr(t, f) == getattr(j, f), f
    (tcfg.dirs.models / "pose").mkdir(parents=True)
    if "LAMENESS_POSE_PIXELS" not in env:
        assert tspec(tcfg).pose_pixels and not tspec(
            tconfig.Config(dirs=tconfig.DataDirs(str(tmp_path / "x")))
        ).pose_pixels


def test_process_subcommand(tmp_path, capsys):
    """``python -m lameness_tpu_torch --cpu --data DIR process VIDEO
    --small``: the motion fallback, the test-geometry engine, the fusion
    result printed."""
    from lameness_tpu_torch.__main__ import main
    src = write_video(tmp_path / "walk", list(textured_walk(n=80)), 10,
                      device="cpu")
    rc = main(["--cpu", "--data", str(tmp_path / "data"), "process",
               str(src), "--small"])
    printed = capsys.readouterr().out.strip().splitlines()[-1]
    assert rc == 0
    fusion = list((tmp_path / "data" / "results" / "fusion").glob(
        "*_fusion.json"))
    assert len(fusion) == 1
    result = json.loads(fusion[0].read_text())["fusion_result"]
    assert printed.startswith("{") and "'final_probability'" in printed
    assert f"{result['final_probability']!r}" in printed
    quality = json.loads(next((tmp_path / "data" / "quality_reports").glob(
        "*_quality.json")).read_text())
    assert quality["status"] == "success"
