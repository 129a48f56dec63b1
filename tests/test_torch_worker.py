"""The port's ``worker`` and wire-server subcommands
(``lameness_tpu_torch/__main__.py``) and its ``device_trace``, on the CPU.

- The worker with ``--cpu --small``, started through the function ``main``
  calls, on a port broker: a JAX ``NatsClient`` publishes the
  ``video.uploaded`` that ``PipelineDriver.ingest`` publishes and sees
  every message of the job (the pipeline subjects, ``analysis.complete``),
  each once.  The worker's
  result files equal, key by key, the same app's run on the in-process bus
  (a local store, SQLite); no ``_via_nats`` reaches a file or a row; its
  stop line carries the launch counts (0 on the CPU).
- Without a broker the worker runs on its local bus, and without ``--cpu``
  and a card the worker and the ``qdrant-server`` raise.
- ``nats-server``, ``qdrant-server`` and ``pg-server`` as subprocesses with
  ``--port 0``: the first line names the bound port, one client round trip,
  SIGINT, exit 0.
- ``device_trace`` on the CPU writes a Chrome trace.

Every wait has a timeout and every server and subprocess is stopped in a
``finally``, so a hang fails instead of running out the suite's clock.
"""
import json
import queue
import re
import shutil
import signal
import subprocess
import sys
import threading
from datetime import datetime, timezone
from pathlib import Path

import numpy as np
import pytest
import torch

from lameness_tpu.io.nats_wire import NatsClient
from lameness_tpu_torch.__main__ import (parse_args, start_qdrant_server,
                                         start_worker, stop_worker)
from lameness_tpu_torch.core.config import Config
from lameness_tpu_torch.io import db as tdb
from lameness_tpu_torch.io.nats_wire import NatsServer
from lameness_tpu_torch.ops._cuda import KERNELS
from lameness_tpu_torch.pipeline.engine import make_test_engine
from lameness_tpu_torch.serve.app import LamenessApp
from lameness_tpu_torch.utils.timing import device_trace
from lameness_tpu_torch.video.decode import write_video
from test_torch_chain import _same_json, one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 120.0
UUID = re.compile(r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-"
                  r"[0-9a-f]{12}")


def _upload(root):
    frames = np.random.default_rng(0).integers(0, 256, (40, 90, 160, 3),
                                               np.uint8)
    return write_video(Path(root) / "upload", frames, 10, device="cpu")


def _results(root):
    """Every result file under the data root ``root``, uuids named
    alike."""
    out = {}
    for p in sorted((Path(root) / "results").glob("*/*.json")):
        out[p.relative_to(root).as_posix()] = json.loads(
            UUID.sub("<uuid>", p.read_text()))
    return out


def _db_text(db):
    return json.dumps([db.query(f"SELECT * FROM {t}") for t in tdb.TABLES])


def test_worker_over_nats_equals_the_in_process_app(tmp_path, capsys):
    src = _upload(tmp_path)
    vid = "walk-1"
    broker = NatsServer()
    broker.start()
    app = bridge = client = None
    try:
        url = f"nats://127.0.0.1:{broker.port}"
        app, bridge = start_worker(parse_args(
            ["--cpu", "--data", str(tmp_path / "worker"), "worker",
             "--nats-url", url, "--small"]))
        out = capsys.readouterr().out
        assert "NATS bridge: connected" in out and "worker ready" in out
        seen, analysed, ended = [], threading.Event(), threading.Event()
        client = NatsClient(url, name="uploader").connect(timeout_s=10)
        for subject in vars(app.config.subjects).values():
            if subject != "video.uploaded":             # its own publish
                client.subscribe(subject, lambda m, s=subject: seen.append(
                    (s, m)))
        client.subscribe("analysis.complete", lambda m: analysed.set())
        # the bus dispatches synchronously: video.preprocessed's handler
        # runs the engine and the back half (analysis.complete goes out
        # from inside it), and the bridge mirrors video.preprocessed itself
        # last, once that handler has returned
        client.subscribe("video.preprocessed", lambda m: ended.set())
        assert client.flush(10)
        # what PipelineDriver.ingest does: the upload under data/videos,
        # then video.uploaded
        dest = app.dirs.videos / f"{vid}.y4m"
        shutil.copyfile(src, dest)
        client.publish("video.uploaded", {
            "video_id": vid, "filename": src.name, "path": str(dest),
            "uploaded_at": datetime.now(timezone.utc).isoformat()})
        assert analysed.wait(TIMEOUT_S) and ended.wait(TIMEOUT_S), seen
        assert client.flush(10)
        record = stop_worker(app, bridge)
        bridge = None
        line = capsys.readouterr().out.strip().splitlines()[-1]
        assert json.loads(line.split(" ", 2)[2]) == record
        # the nine kernels of ops/_cuda.py, none launched on the CPU
        assert record["launches"] == dict.fromkeys(KERNELS, 0)
        assert len(KERNELS) == 9
        assert record["peak_gb"] is None
        assert {"curation.track", "decode", "engine", "tracking"} <= \
            set(record["timers"])
        worker_db = _db_text(app.db)
        worker_subjects = [m["subject"] for m in app.bus.history]
    finally:
        if client is not None:
            client.close()
        if bridge is not None:
            bridge.stop()
        if app is not None:
            app.close()
        broker.stop()

    ref = LamenessApp(config=Config.load(data_root=str(tmp_path / "ref")),
                      engine=make_test_engine(device="cpu"), reactive=True)
    try:
        assert ref.submit_video(src, vid) == vid
        assert ref.wait_for_analysis(vid, timeout_s=5) is not None
    finally:
        ref.close()
    ref_subjects = [m["subject"] for m in ref.bus.history]
    # the worker's bus heard the upload from the socket, every other
    # message came from its own chain, as on the in-process bus
    assert worker_subjects == ref_subjects
    assert app.bus.history[0]["payload"]["_via_nats"] is True
    # the external subscriber saw each of the worker's messages once, as
    # the in-process bus carried them
    assert sorted(s for s, _ in seen) == sorted(ref_subjects[1:])
    assert [m for s, m in seen if s == "video.preprocessed"][0][
        "video_id"] == vid
    for subject, msg in seen:
        assert "_via_nats" not in msg, subject
    got, want = _results(tmp_path / "worker"), _results(tmp_path / "ref")
    assert sorted(got) == sorted(want)
    assert {n.split("/")[1] for n in got} >= {
        "yolo", "sam3", "dinov3", "tleap", "tcn", "transformer", "tracking",
        "gnn", "graph_transformer", "ml", "fusion", "shap", "explanations"}
    for name in want:
        _same_json(got[name], want[name], name)
        assert "_via_nats" not in json.dumps(got[name]), name
    assert "_via_nats" not in worker_db
    assert "completed" in worker_db


@pytest.mark.parametrize("nats", ["none", "unreachable"])
def test_worker_without_a_broker(tmp_path, capsys, nats):
    argv = ["--cpu", "--data", str(tmp_path), "worker", "--small"]
    if nats == "unreachable":
        srv = NatsServer()
        srv.start()
        srv.stop()                          # the port, with nobody on it
        argv += ["--nats-url", f"nats://127.0.0.1:{srv.port}"]
    app, bridge = start_worker(parse_args(argv))
    try:
        out = capsys.readouterr().out
        assert out.endswith("worker ready\n")
        assert ("local bus only" in out) == (nats == "none")
        assert ("NATS bridge: UNREACHABLE" in out) == (nats != "none")
        assert bridge is None or bridge._nc is None
    finally:
        stop_worker(app, bridge)


def test_worker_and_vector_server_need_a_card_unless_cpu(tmp_path,
                                                         monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        start_worker(parse_args(["--data", str(tmp_path), "worker",
                                 "--small"]))
    with pytest.raises(RuntimeError, match="CUDA"):
        start_qdrant_server(parse_args(["qdrant-server", "--port", "0"]))
    srv = start_qdrant_server(parse_args(["--cpu", "qdrant-server",
                                          "--port", "0"]))
    srv.stop()
    assert srv.store.device == torch.device("cpu")


def _lines(proc):
    """A queue fed with ``proc``'s output lines by a daemon thread."""
    q = queue.Queue()

    def pump():
        for line in proc.stdout:
            q.put(line)
        q.put(None)
    threading.Thread(target=pump, daemon=True).start()
    return q


def _round_trip(kind, url, tmp_path):
    if kind == "nats-server":
        got = []
        c = NatsClient(url).connect(timeout_s=10)
        try:
            c.subscribe("ping.me", got.append)
            assert c.flush(10)
            c.publish("ping.me", {"x": 1})
            assert c.flush(10)
        finally:
            c.close()
        assert got == [{"x": 1}]
    elif kind == "qdrant-server":
        from lameness_tpu.io.qdrant_wire import QdrantRestStore
        s = QdrantRestStore(url, timeout_s=10)
        assert s.ping()
        s.upsert("c", "p", [1.0, 2.0], payload={"k": 1})
        hits = s.search("c", [1.0, 2.0], top_k=1)
        assert [(h.id, h.payload) for h in hits] == [("p", {"k": 1})]
        assert abs(hits[0].score - 1.0) < 1e-6
    else:
        from lameness_tpu.io import pg_wire
        c = pg_wire.connect(url.replace("***", "pw"), timeout=10)
        try:
            assert c.execute("SELECT 1 + 1 AS two").fetchall() == [(2,)]
        finally:
            c.close()
        assert (tmp_path / "pg.sqlite").exists()


@pytest.mark.parametrize("kind", ["nats-server", "qdrant-server",
                                  "pg-server"])
def test_server_subcommand(tmp_path, kind):
    extra = {"nats-server": [],
             "qdrant-server": ["--persist", str(tmp_path / "vec.json")],
             "pg-server": ["--path", str(tmp_path / "pg.sqlite"),
                           "--user", "u", "--password", "pw"]}[kind]
    proc = subprocess.Popen(
        [sys.executable, "-m", "lameness_tpu_torch", "--cpu", kind,
         "--port", "0"] + extra, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    lines = _lines(proc)
    try:
        first = lines.get(timeout=60)
        assert first, "exited before its first line"
        url = first.split()[-1]
        port = int(re.search(r":(\d+)(/|$)", url.split("@")[-1]).group(1))
        assert port > 0
        _round_trip(kind, url, tmp_path)
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            rc = proc.wait(timeout=30)
        finally:
            if proc.poll() is None:
                proc.kill()
    assert rc == 0
    if kind == "qdrant-server":
        assert json.loads((tmp_path / "vec.json").read_text())["c"]["ids"] \
            == ["p"]


def test_device_trace_on_the_cpu(tmp_path, monkeypatch):
    a = torch.ones(64, 64)
    with device_trace(tmp_path / "trace", device="cpu") as path:
        (a @ a).sum()
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    assert path.parent == tmp_path / "trace"
    # the card by default: without one it raises instead of tracing less
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        with device_trace(tmp_path / "t2"):
            pass
    # a torch without a profiler: the block runs untraced
    monkeypatch.setitem(sys.modules, "torch.profiler", None)
    ran = []
    with device_trace(tmp_path / "t3", device="cpu") as path:
        ran.append(1)
    assert path is None and ran == [1]
    assert not (tmp_path / "t3").exists()
