"""``python -m lameness_tpu_torch`` (port of ``lameness_tpu/__main__.py``).

  python -m lameness_tpu_torch serve [--port 8000] [--data DIR] [--async]
                                     [--small] [--no-resume] [--batch N]
                                     [--nats-url nats://host:4222]
  python -m lameness_tpu_torch worker [--nats-url nats://host:4222]
                                      [--warmup] [--batch N] [--small]
  python -m lameness_tpu_torch process VIDEO [--data DIR] [--small]
  python -m lameness_tpu_torch resume [--data DIR] [--small]
  python -m lameness_tpu_torch nats-server [--host H] [--port 4222]
  python -m lameness_tpu_torch qdrant-server [--port 6333] [--persist F]
  python -m lameness_tpu_torch pg-server [--port 5432] [--path F]
                                         [--user U] [--password P]

``serve`` boots the reactive app (``serve/app.py`` ``LamenessApp``) with the
admin API and its SPA, resumes stranded jobs and warms the engine up in the
background; with ``--nats-url`` its bus is bridged to a NATS broker.
``worker`` is the headless engine of the compose topology: an app without
the API whose bus is bridged to the broker at ``--nats-url`` (default
``$LAMENESS_NATS_URL``), so a ``video.uploaded`` message on the socket runs
curation, the engine, tracking, the heads and fusion in the worker; on
Ctrl-C it prints its kernels' launch counts.  ``process`` runs one video
through the app and prints the fusion result; ``resume`` replays the jobs a
crash left ``processing``.  ``nats-server``, ``qdrant-server`` and
``pg-server`` run the wire servers of ``io/`` (the broker, the vector
store, the Postgres-wire database over SQLite); each prints its URL with
the port it bound, so ``--port 0`` works.  A ``postgres://``
``DATABASE_URL`` puts the app's database on a ``pg-server``.

The engine and the ``qdrant-server``'s store run on the card (with
``--cpu``, on the CPU), the engine in bf16 unless ``--f32``.  An upload is
an ``.mp4`` (``.m4v``, ``.mov``) whose video is mp4v, or a ``.y4m`` file,
which the port decodes itself, or any other file the ``ffmpeg`` binary
decodes.  ``--dp N``
/ ``--tp M`` (or ``LAMENESS_DP``/``LAMENESS_TP``) shard the engine's
inference over a (data=N, model=M) mesh of the visible cards, each once
(``--dp auto``: all of them; with ``--cpu``, the one CPU device).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import threading
import time
from pathlib import Path


def ingest_spec(cfg=None):
    """EngineSpec honoring LAMENESS_INGEST:

    - ``WxH`` (e.g. ``1024x576``): process at a reduced ingest resolution.
      The driver decodes, resizes to the engine's geometry and maps results
      back to native coordinates.
    - ``WxH+WlxHl`` (e.g. ``1024x576+640x360``): split-resolution ingest:
      det/SAM frames at the first geometry (the coordinate space),
      dino/pose frames at the second.

    ``pose_pixels`` follows whether a trained pose checkpoint
    (``<models>/pose``) exists: the heuristic keypoint path never reads
    pose pixels, so pose-only frames are left off the wire (the same
    outputs).  ``LAMENESS_POSE_PIXELS=1/0`` overrides; ``LAMENESS_SAM_RECT=1``
    selects the rect SAM canvas."""
    from .pipeline.engine import EngineSpec
    rect = os.environ.get("LAMENESS_SAM_RECT") == "1"
    env_pp = os.environ.get("LAMENESS_POSE_PIXELS")
    if env_pp is not None:
        pose_pixels = env_pp != "0"
    elif cfg is not None:
        pose_pixels = (Path(cfg.dirs.models) / "pose").exists()
    else:
        pose_pixels = True
    ingest = os.environ.get("LAMENESS_INGEST")
    if not ingest:
        return EngineSpec(sam_rect=rect, pose_pixels=pose_pixels)
    parts = ingest.lower().split("+")
    w, h = (int(v) for v in parts[0].split("x"))
    if len(parts) > 1:
        lw, lh = (int(v) for v in parts[1].split("x"))
        return EngineSpec(frame_height=h, frame_width=w,
                          lo_height=lh, lo_width=lw, sam_rect=rect,
                          pose_pixels=pose_pixels)
    return EngineSpec(frame_height=h, frame_width=w, sam_rect=rect,
                      pose_pixels=pose_pixels)


def _shard(args, engine) -> None:
    """``--dp``/``--tp`` (or ``LAMENESS_DP``/``LAMENESS_TP``): inference
    over a (data, model) mesh of the visible cards, each once (with
    ``--cpu``, the one CPU device); ``--dp auto`` takes them all."""
    import torch
    from .parallel.mesh import make_mesh
    dp = args.dp or os.environ.get("LAMENESS_DP")
    tp = int(args.tp or os.environ.get("LAMENESS_TP") or 1)
    if not (dp or tp > 1):
        return
    visible = 1 if args.cpu else torch.cuda.device_count()
    n = visible if str(dp) == "auto" else int(dp or 1) * tp
    if n > visible:
        raise SystemExit(f"--dp {dp} --tp {tp}: needs {n} devices, only "
                         f"{visible} visible")
    if n % tp != 0:
        raise SystemExit(f"--dp {dp} --tp {tp}: {n} devices do not divide "
                         f"into a (data={n // tp}, model={tp}) grid — tp "
                         f"must divide the device count")
    devices = [torch.device("cpu")] if args.cpu else None
    engine.shard_inference(make_mesh(n, model_parallel=tp, devices=devices))
    print(f"mesh: inference sharded over {n} devices (data={n // tp}, "
          f"model={tp})", flush=True)


def _build(args):
    """(config, engine) of the command line: the test-geometry engine with
    ``--small``, else the full engine at ``ingest_spec``'s geometry, in
    bf16 on the card unless ``--f32``.  TF32 is off, so float32 matmuls
    and cuDNN's float32 convolutions (the TCN, SAM's mask decoder) keep
    float32's precision, as the tests hold them."""
    import torch
    from .core.config import ComputeConfig, Config
    from .pipeline.engine import LamenessEngine, make_test_engine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = "cpu" if args.cpu else None
    cfg = Config.load(data_root=args.data) if args.data else Config()
    if args.f32:
        cfg = dataclasses.replace(cfg, compute=ComputeConfig(dtype="float32"))
    if getattr(args, "small", False):
        engine = make_test_engine(device=device)
    else:
        engine = LamenessEngine(config=cfg, spec=ingest_spec(cfg),
                                device=device)
        if engine.precision:
            print("precision:", engine.precision, flush=True)
    # after the precision policy, so the replicas carry its dtypes
    _shard(args, engine)
    return cfg, engine


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="lameness_tpu_torch")
    ap.add_argument("--data", help="data root directory")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the plain PyTorch path)")
    ap.add_argument("--f32", action="store_true",
                    help="disable the bf16 engine policy (card default: "
                         "encoders bf16 per config.compute.dtype)")
    ap.add_argument("--dp", default=None,
                    help="data-parallel serving over N cards ('auto': all "
                         "visible)")
    ap.add_argument("--tp", type=int, default=None,
                    help="tensor-parallel DINO over N cards of each data "
                         "replica")
    sub = ap.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("serve", help="reactive app + admin API")
    s.add_argument("--port", type=int, default=8000)
    s.add_argument("--async", dest="async_dispatch", action="store_true",
                   help="worker-pool bus dispatch")
    s.add_argument("--small", action="store_true",
                   help="test-geometry engine")
    s.add_argument("--no-resume", action="store_true")
    s.add_argument("--batch", type=int, default=1,
                   help="group queued clips into engine batches of N")
    s.add_argument("--nats-url", default=None,
                   help="bridge bus subjects to a NATS server (ours via "
                        "'nats-server', or a stock Go one)")

    w = sub.add_parser("worker",
                       help="headless inference worker: reactive engine "
                            "consuming the shared NATS bus, no admin API")
    w.add_argument("--nats-url", required=False,
                   default=os.environ.get("LAMENESS_NATS_URL"),
                   help="broker to join (default $LAMENESS_NATS_URL)")
    w.add_argument("--warmup", action="store_true",
                   help="build the kernels and run each stage once before "
                        "joining")
    w.add_argument("--batch", type=int, default=1)
    w.add_argument("--small", action="store_true")

    p = sub.add_parser("process", help="one video through the pipeline")
    p.add_argument("video", type=Path)
    p.add_argument("--small", action="store_true",
                   help="test-geometry engine")

    rs = sub.add_parser("resume", help="replay stranded processing jobs")
    rs.add_argument("--small", action="store_true",
                    help="test-geometry engine (tiny frames; for tests only "
                         "— production resumes use the full engine)")

    ns = sub.add_parser("nats-server", help="run the NATS core broker")
    ns.add_argument("--host", default="127.0.0.1")
    ns.add_argument("--port", type=int, default=4222)

    qs = sub.add_parser("qdrant-server",
                        help="run the Qdrant-REST vector server")
    qs.add_argument("--host", default="127.0.0.1")
    qs.add_argument("--port", type=int, default=6333)
    qs.add_argument("--persist", default=None,
                    help="JSON persistence path for the backing store")

    ps = sub.add_parser("pg-server",
                        help="run the Postgres-wire DB server (SQLite-"
                             "backed; pair with DATABASE_URL)")
    ps.add_argument("--host", default="127.0.0.1")
    ps.add_argument("--port", type=int, default=5432)
    ps.add_argument("--path", default=":memory:",
                    help="backing SQLite file (default in-memory)")
    ps.add_argument("--user", default="lameness_user")
    ps.add_argument("--password", default="lameness_pass")
    return ap.parse_args(argv)


def start_nats_server(args):
    """The broker of ``nats-server``, started; its URL printed."""
    from .io.nats_wire import NatsServer
    srv = NatsServer(host=args.host, port=args.port)
    port = srv.start()
    print(f"NATS broker listening on nats://{args.host}:{port}", flush=True)
    return srv


def start_qdrant_server(args):
    """The vector server of ``qdrant-server``, started, its store on the
    card (the CPU with ``--cpu``; without a card, raises); its URL
    printed."""
    from .core.device import resolve_device
    from .io.qdrant_wire import QdrantRestServer
    from .io.vecstore import VectorStore
    store = VectorStore(persist_path=Path(args.persist)
                        if args.persist else None,
                        device=resolve_device("cpu" if args.cpu else None))
    srv = QdrantRestServer(store=store, host=args.host, port=args.port)
    port = srv.start()
    print(f"Qdrant-REST vector server on http://{args.host}:{port}",
          flush=True)
    return srv


def start_pg_server(args):
    """The Postgres-wire server of ``pg-server``, started; its URL printed
    (the password masked)."""
    from .io.pg_wire import PgWireServer
    srv = PgWireServer(path=args.path, host=args.host, port=args.port,
                       users={args.user: args.password})
    port = srv.start()
    print(f"Postgres-wire DB server on postgres://{args.user}:***@"
          f"{args.host}:{port}/lameness_db", flush=True)
    return srv


def _bridge(app, url):
    """A ``NatsBridge`` of ``app``'s bus to ``url`` over every subject of
    the config, started; whether it connected printed.  "connected" means
    the broker holds the bridge's subscriptions (a flush came back), so a
    message published after it reaches the app."""
    from .io.bus import NatsBridge
    subjects = [v for v in vars(app.config.subjects).values()
                if isinstance(v, str)]
    bridge = NatsBridge(app.bus, url, subjects=subjects)
    print("NATS bridge:", "connected" if bridge.start() and bridge.flush()
          else f"UNREACHABLE at {url} (running without)", flush=True)
    return bridge


def start_serve(args):
    """``serve``'s app with its API (and its bridge with ``--nats-url``).
    Returns (app, bridge or None); ``main`` warms the engine up."""
    from .serve.app import LamenessApp
    cfg, engine = _build(args)
    app = LamenessApp(config=cfg, engine=engine, reactive=True,
                      serve_api=True, api_port=args.port,
                      async_dispatch=args.async_dispatch,
                      resume_inflight=not args.no_resume,
                      clip_batch=args.batch)
    bridge = _bridge(app, args.nats_url) if args.nats_url else None
    print(f"admin UI at http://127.0.0.1:{app.server.port}", flush=True)
    return app, bridge


def start_worker(args):
    """``worker``'s app: no API, the engine warmed up first with
    ``--warmup``, then its bus bridged to ``--nats-url`` (so no job runs
    during the warmup, and none is missed by the launch counts it zeroes).
    The bridge's reader thread runs each job (curation, the engine, the
    back half), as the JAX worker's does.  Prints ``worker ready``;
    returns (app, bridge or None)."""
    from .serve.app import LamenessApp
    cfg, engine = _build(args)
    app = LamenessApp(config=cfg, engine=engine, reactive=True,
                      serve_api=False, clip_batch=args.batch)
    if args.warmup:
        from .ops._cuda import KERNELS
        print("warmup:", engine.warmup(batch=max(1, args.batch)),
              flush=True)
        for k in KERNELS.values():       # stop_worker counts the jobs' own
            k.launches = 0
    if args.nats_url:
        bridge = _bridge(app, args.nats_url)
    else:
        bridge = None
        print("worker: no --nats-url / $LAMENESS_NATS_URL — local bus "
              "only", flush=True)
    print("worker ready", flush=True)
    return app, bridge


def stop_worker(app, bridge) -> dict:
    """Stop the bridge and close the app; print (and return) the kernels'
    launch counts (``ops/_cuda.py`` ``KERNELS``, since ``worker ready``),
    the stage timers and the peak device memory, on one line."""
    import torch
    from .ops._cuda import KERNELS
    from .utils.timing import TIMERS
    if bridge is not None:
        bridge.stop()
    app.close()
    on_card = app.driver.engine.device.type == "cuda"
    record = {
        "launches": {name: k.launches for name, k in KERNELS.items()},
        "timers": {**app.driver.curator.timers.summary(),
                   **TIMERS.summary()},
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9 if on_card
        else None}
    print("worker stopped " + json.dumps(record), flush=True)
    return record


def _until_interrupt(stop) -> int:
    """Sleep until Ctrl-C (SIGINT), then ``stop()``."""
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        stop()
    return 0


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.cmd in ("nats-server", "pg-server"):
        start = {"nats-server": start_nats_server,
                 "pg-server": start_pg_server}[args.cmd]
        return _until_interrupt(start(args).stop)
    if args.cmd == "qdrant-server":
        srv = start_qdrant_server(args)

        def stop():
            srv.stop()
            if srv.store.device.type == "cuda":
                import torch
                print("qdrant-server stopped " + json.dumps({
                    "peak_gb": torch.cuda.max_memory_allocated() / 1e9}),
                    flush=True)
        return _until_interrupt(stop)
    if args.cmd == "worker":
        app, bridge = start_worker(args)
        return _until_interrupt(lambda: stop_worker(app, bridge))

    from .serve.app import LamenessApp
    if args.cmd == "serve":
        app, bridge = start_serve(args)
        engine = app.driver.engine
        # build the kernels and run each stage once (at the batch size the
        # batcher pads to) off the request path
        threading.Thread(
            target=lambda: print("warmup:", engine.warmup(
                batch=max(1, args.batch)), flush=True),
            daemon=True, name="engine-warmup").start()

        def stop():
            if bridge is not None:
                bridge.stop()
            app.close()
        return _until_interrupt(stop)
    if args.cmd == "process":
        cfg, engine = _build(args)
        app = LamenessApp(config=cfg, engine=engine, reactive=True)
        try:
            vid = app.submit_video(args.video)
            result = app.wait_for_analysis(vid, timeout_s=600)
        finally:
            app.close()
        print(result and result.get("fusion_result"))
        return 0 if result else 1
    if args.cmd == "resume":
        # stranded jobs replay through the same geometry serve and process
        # use: the tiny engine would overwrite real result files
        cfg, engine = _build(args)
        app = LamenessApp(config=cfg, engine=engine, reactive=True)
        try:
            n = app.resume_inflight_jobs()
        finally:
            app.close()
        print(f"resumed {n} job(s)")
        return 0
    return 2


if __name__ == "__main__":
    sys.exit(main())
