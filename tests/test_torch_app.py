"""The port's ``LamenessApp`` (``serve/app.py``), its ``ClipBatcher`` and
the ``serve``/``resume`` subcommands against the JAX package's app, on the
CPU.

Both apps take the same ``.y4m`` upload through ``submit_video`` and run
the reactive chain over the bus, on tests/test_torch_chain.py's setup: the
tiny engines at the crop's geometry (the JAX weights carried over by
``weights.from_jax_params``), the square detector for curation, the JAX
runner's graph-head weights, and the cvtColor Y4M pair on the JAX side.

- One upload: every result file within PERF.md §2's 1e-4, the same bus
  subjects in the same order, equal job and lameness-record rows and
  heartbeats, and the SHAP and LLM files.
- The batcher at B = 2 over three uploads whose crops reach it back to
  back: grouped into two engine calls, each video's stage files and
  fusion probability as JAX's batched app gives them.
- A corrupt upload marks its job failed, on both sides.
- Resume: a job left ``processing`` with its crop on disk completes.
- The ``serve`` subcommand booted (the API answers) and stopped, with
  ``--nats-url`` joined to a port broker, the ``resume`` subcommand, and
  the mesh's arguments (not ported) raising.
"""
import itertools
import json
import signal
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest

from lameness_tpu.serve import app as japp_mod
from lameness_tpu_torch.serve import app as tapp_mod
from lameness_tpu_torch.serve.graph_runner import GraphHeadRunner
from lameness_tpu_torch.video.decode import write_video
from test_torch_chain import (ANALYSIS, STAGES, _configs, _crop_geometry,
                              _curators, _engines, _graph_runners,
                              _same_json, _upload, counted_uuids,
                              one_torch_thread)
from test_torch_curation import synthetic_walk_frames
from test_torch_decode import swap_jax_io
from test_torch_graph import N_PAD

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """The two tiny engines at the square upload's crop geometry."""
    tmp = tmp_path_factory.mktemp("geometry")
    with pytest.MonkeyPatch.context() as mp:
        swap_jax_io(mp)
        h, w = _crop_geometry(tmp, _upload(tmp, "square"), "square", mp)
    return _engines(h, w)


def _apps(tmp_path, engines, **kw):
    jeng, teng = engines
    jcfg, tcfg = _configs(tmp_path)
    jc, tc = _curators("square", jcfg, tcfg)
    ja = japp_mod.LamenessApp(config=jcfg, engine=jeng, reactive=True, **kw)
    ta = tapp_mod.LamenessApp(config=tcfg, engine=teng, reactive=True, **kw)
    ja.driver.curator, ta.driver.curator = jc, tc
    _graph_runners(ja.driver, ta.driver)
    return ja, ta


def _rows(db, sql):
    out = []
    for r in db.query(sql):
        out.append({k: v for k, v in r.items()
                    if not k.endswith(("_at", "_date", "id"))
                    and k != "last_heartbeat"})
    return out


def _results(root):
    return sorted(p.relative_to(root).as_posix()
                  for p in (Path(root) / "results").glob("*/*.json"))


def test_app_matches_jax(tmp_path, monkeypatch, engines, counted_uuids):
    swap_jax_io(monkeypatch)
    src = _upload(tmp_path, "square")
    ja, ta = _apps(tmp_path, engines)
    fusion = {}
    try:
        for tag, app in (("jax", ja), ("port", ta)):
            counted_uuids[0] = itertools.count()
            assert app.submit_video(src, "vid") == "vid"
            fusion[tag] = app.wait_for_analysis("vid", timeout_s=5)
    finally:
        ja.close()
        ta.close()
    assert fusion["port"] is not None
    _same_json(fusion["port"], fusion["jax"], "fusion")
    roots = {"jax": Path(ja.dirs.root), "port": Path(ta.dirs.root)}
    names = _results(roots["jax"])
    assert names == _results(roots["port"])
    kinds = {n.split("/")[1] for n in names}
    assert kinds >= set(STAGES + ANALYSIS) | {"shap", "explanations"}
    for name in names:
        _same_json(json.loads((roots["port"] / name).read_text()),
                   json.loads((roots["jax"] / name).read_text()), name)
    assert [m["subject"] for m in ta.bus.history] == \
        [m["subject"] for m in ja.bus.history]
    for m_t, m_j in zip(ta.bus.history, ja.bus.history):
        _same_json(m_t["payload"], m_j["payload"], m_j["subject"])
    for sql in ("SELECT * FROM processing_jobs",
                "SELECT * FROM lameness_records",
                "SELECT * FROM cow_identities",
                "SELECT service_name, status, active_jobs, success_count, "
                "error_count FROM service_heartbeats "
                "ORDER BY service_name"):
        assert _rows(ta.db, sql) == _rows(ja.db, sql), sql
    assert ta.db.one("SELECT status FROM processing_jobs")["status"] == \
        "completed"
    shap = json.loads((roots["port"] / "results/shap/vid_shap.json"
                       ).read_text())
    assert shap["status"] == "no_models"
    assert (roots["port"] / "processed" / "vid_cropped.mp4").exists()


def test_batcher_matches_jax(tmp_path, monkeypatch, engines):
    """Three uploads through ``ClipBatcher`` at B = 2 on both sides.  Each
    upload is curated and cropped in the submitting thread; the batcher
    gets the three crops back to back, and groups them into one stream of
    two engine calls."""
    swap_jax_io(monkeypatch)
    srcs = [write_video(tmp_path / f"up{i}", synthetic_walk_frames(
        n_frames=70, w=320, h=90, fps=10, size=30), 10, device="cpu")
        for i in range(3)]
    ja, ta = _apps(tmp_path, engines, clip_batch=2, batch_window_s=1.0)
    try:
        for app in (ja, ta):
            held = []
            app._batcher.submit = lambda vid, path: held.append((vid, path))
            for i, src in enumerate(srcs):
                app.submit_video(src, f"b{i}")
            del app._batcher.submit
            assert [vid for vid, _ in held] == ["b0", "b1", "b2"]
            for job in held:
                app._batcher.submit(*job)
            for i in range(3):
                assert app.wait_for_analysis(f"b{i}", timeout_s=120), i
            deadline = time.time() + 60
            while app._batcher.clips_run < 3 and time.time() < deadline:
                time.sleep(0.05)
    finally:
        ja.close()
        ta.close()
    assert ta._batcher.clips_run == ja._batcher.clips_run == 3
    assert ta._batcher.batches_run == ja._batcher.batches_run == 2
    for i in range(3):
        for kind in STAGES:
            name = f"results/{kind}/b{i}_{kind}.json"
            _same_json(json.loads((Path(ta.dirs.root) / name).read_text()),
                       json.loads((Path(ja.dirs.root) / name).read_text()),
                       name)
        f = [json.loads((Path(a.dirs.root) / f"results/fusion/b{i}_fusion"
                                            ".json").read_text())
             for a in (ja, ta)]
        assert abs(f[1]["fusion_result"]["final_probability"]
                   - f[0]["fusion_result"]["final_probability"]) <= 1e-4
    jobs = ta.db.query("SELECT status FROM processing_jobs")
    assert [j["status"] for j in jobs] == ["completed"] * 3


@pytest.mark.parametrize("data", [
    b"not a video at all",                           # fails at decode
    b"YUV4MPEG2 W64 H36 F10:1 C420jpeg\nFRA"],        # no frame: the engine
    ids=["garbage", "truncated"])
def test_corrupt_upload_marks_job_failed(tmp_path, monkeypatch, engines,
                                         data):
    swap_jax_io(monkeypatch)
    bad = tmp_path / "bad.y4m"
    bad.write_bytes(data)
    ja, ta = _apps(tmp_path, engines)
    try:
        for app in (ja, ta):
            app.submit_video(bad, "bad")
    finally:
        ja.close()
        ta.close()
    rows = [a.db.one("SELECT status, error_message FROM processing_jobs "
                     "WHERE video_id='bad'") for a in (ja, ta)]
    assert rows[1]["status"] == rows[0]["status"] == "failed"
    assert rows[1]["error_message"]
    failing = [{r["service_name"] for r in a.db.query(
        "SELECT service_name FROM service_heartbeats WHERE error_count > 0")}
        for a in (ja, ta)]
    assert failing[1] == failing[0] and len(failing[1]) == 1
    assert ta.bus.errors and ja.bus.errors


def _strand(tmp_path, engines):
    """A finished upload, then its fusion file removed and its job put back
    to 'processing': what a crash after the crop leaves."""
    _, teng = engines
    _, tcfg = _configs(tmp_path)
    _, tc = _curators("square", tcfg, tcfg)
    app = tapp_mod.LamenessApp(config=tcfg, engine=teng, reactive=True)
    app.driver.curator = tc
    app.driver.graph_runner = GraphHeadRunner(
        tcfg, bus=app.bus, max_nodes=N_PAD, device="cpu")
    src = _upload(tmp_path, "square")
    app.submit_video(src, "st")
    assert app.wait_for_analysis("st", timeout_s=5)
    app.close()
    (tcfg.dirs.results_for("fusion") / "st_fusion.json").unlink()
    job = app.db.one("SELECT job_id FROM processing_jobs")
    app.db.update("processing_jobs", job["job_id"],
                  {"status": "processing"}, pk="job_id")
    return tcfg


def test_resume_inflight_job(tmp_path, engines):
    tcfg = _strand(tmp_path, engines)
    app = tapp_mod.LamenessApp(config=tcfg, engine=engines[1],
                               reactive=False)
    app.driver.graph_runner = GraphHeadRunner(
        tcfg, bus=app.bus, max_nodes=N_PAD, device="cpu")
    app._wire_bus()
    assert app.resume_inflight_jobs() == 1
    try:
        assert app.wait_for_analysis("st", timeout_s=5) is not None
        assert app.db.one("SELECT status FROM processing_jobs")["status"] \
            == "completed"
        # nothing left to resume; a job with no artifacts is failed
        app.db.insert("processing_jobs", {"video_id": "ghost",
                                          "status": "processing"})
        assert app.resume_inflight_jobs() == 0
        assert app.db.one("SELECT status FROM processing_jobs WHERE "
                          "video_id='ghost'")["status"] == "failed"
    finally:
        app.close()


def test_resume_subcommand(tmp_path, engines, capsys):
    from lameness_tpu_torch.__main__ import main
    tcfg = _strand(tmp_path, engines)
    capsys.readouterr()
    assert main(["--cpu", "--data", tcfg.dirs.root, "resume",
                 "--small"]) == 0
    assert capsys.readouterr().out.strip().endswith("resumed 1 job(s)")
    assert (tcfg.dirs.results_for("fusion") / "st_fusion.json").exists()


def test_serve_subcommand_boots_and_stops(tmp_path):
    """``python -m lameness_tpu_torch --cpu serve --small``: the API and
    the SPA answer, the engine warms up, and Ctrl-C closes the app."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "lameness_tpu_torch", "--cpu", "--data",
         str(tmp_path / "d"), "serve", "--small", "--port", "0",
         "--no-resume", "--batch", "2"], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    lines = []
    try:
        deadline = time.time() + 120
        while not any(l.startswith("warmup: {") for l in lines):
            assert time.time() < deadline and proc.poll() is None, lines
            lines.append(proc.stdout.readline())
        url = next(l for l in lines if l.startswith("admin UI at ")).split()[-1]
        with urllib.request.urlopen(f"{url}/health", timeout=10) as r:
            assert json.loads(r.read())["status"] == "healthy"
        with urllib.request.urlopen(f"{url}/", timeout=10) as r:
            assert b"<html" in r.read().lower()
    finally:
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=60)
    assert rc == 0


def test_serve_nats_url_joins_a_port_broker(tmp_path, capsys):
    """``serve --cpu --small --nats-url`` on a port broker: the bridge
    connects, the app's publications reach a JAX client on the socket, and
    the client's reach the app's bus once, tagged ``_via_nats``."""
    from lameness_tpu.io.nats_wire import NatsClient
    from lameness_tpu_torch.__main__ import parse_args, start_serve
    from lameness_tpu_torch.io.nats_wire import NatsServer
    broker = NatsServer()
    broker.start()
    app = bridge = client = None
    try:
        url = f"nats://127.0.0.1:{broker.port}"
        app, bridge = start_serve(parse_args(
            ["--cpu", "--data", str(tmp_path), "serve", "--small", "--port",
             "0", "--no-resume", "--nats-url", url]))
        assert "NATS bridge: connected" in capsys.readouterr().out
        client = NatsClient(url).connect(timeout_s=10)
        seen = []
        client.subscribe("video.*", seen.append)
        assert client.flush(10)
        app.bus.publish_sync("video.curated", {"video_id": "v"})
        client.publish("hitl.comparison.requested", {"pair": [1, 2]})
        assert client.flush(10) and bridge.flush(10)
        deadline = time.time() + 10
        while not seen and time.time() < deadline:
            time.sleep(0.01)
        assert seen == [{"video_id": "v"}]
        assert app.bus.messages_on("hitl.comparison.requested") == [
            {"pair": [1, 2], "_via_nats": True}]
    finally:
        if client is not None:
            client.close()
        if bridge is not None:
            bridge.stop()
        if app is not None:
            app.close()
        broker.stop()


@pytest.mark.parametrize("argv,item", [
    (["--dp", "2", "serve"], "needs 2 devices, only 1 visible"),
    (["--tp", "2", "process", "x.y4m"], "needs 2 devices, only 1 visible")])
def test_unported_arguments_raise(tmp_path, argv, item):
    """A mesh larger than the visible devices raises JAX's message (under
    ``--cpu`` one device is visible)."""
    from lameness_tpu_torch.__main__ import main
    with pytest.raises(SystemExit, match=item):
        main(["--cpu", "--data", str(tmp_path)] + argv)


def test_dp_auto_serves_on_a_dp1_mesh(tmp_path, capsys):
    """``--cpu --dp auto serve --small``: a (data=1, model=1) mesh of the
    CPU, the API answers, and the engine warms up over the mesh."""
    from lameness_tpu_torch.__main__ import parse_args, start_serve
    app, bridge = start_serve(parse_args(
        ["--cpu", "--dp", "auto", "--data", str(tmp_path / "d"), "serve",
         "--small", "--port", "0", "--no-resume"]))
    try:
        assert bridge is None
        assert "mesh: inference sharded over 1 devices (data=1, model=1)" \
            in capsys.readouterr().out
        eng = app.driver.engine
        assert eng._mesh.shape == {"data": 1, "model": 1}
        assert set(eng.warmup()) == {"detect", "sam", "dino", "heads"}
        url = f"http://127.0.0.1:{app.server.port}"
        with urllib.request.urlopen(f"{url}/health", timeout=10) as r:
            assert json.loads(r.read())["status"] == "healthy"
    finally:
        app.close()
