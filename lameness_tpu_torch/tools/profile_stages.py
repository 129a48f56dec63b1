"""Per-stage latency profile of the engine, with an optional trace (port
of ``scripts/profile_stages.py``): p50/p95 wall times per stage from the
process-wide ``StageTimers`` registry (``utils/timing.TIMERS``) after N
timed runs of ``run_staged`` on one seeded clip, and with ``--trace DIR``
the last run wrapped in ``device_trace`` (a torch.profiler Chrome trace of
the host's ops and the card's kernels):

  python -m lameness_tpu_torch.tools.profile_stages [--runs 5] [--trace DIR] [--small]
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from . import add_device_arg, device_of


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="profile_stages")
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--trace", type=Path,
                    help="write a torch.profiler Chrome trace here")
    ap.add_argument("--small", action="store_true",
                    help="test-geometry engine")
    ap.add_argument("--cpu", action="store_true",
                    help="the same as --device cpu")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = device_of(args)
    from ..pipeline.engine import LamenessEngine, make_test_engine
    from ..utils.timing import TIMERS, device_trace

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    engine = make_test_engine(device=device) if args.small \
        else LamenessEngine(device=device)
    spec = engine.spec
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 255, (1, spec.n_packed, spec.frame_height,
                                   spec.frame_width, 3), dtype=np.uint8)

    def run():
        gen = torch.Generator(device=engine.device).manual_seed(0)
        out = engine.run_staged(engine.to_device(frames), gen)
        return float(out["tcn_probability"][0])

    print("compiling...", flush=True)
    engine.warmup()
    run()

    trace_path = None
    for i in range(args.runs):
        t0 = time.perf_counter()
        if args.trace and i == args.runs - 1:
            with device_trace(args.trace, device) as trace_path:
                run()
        else:
            with TIMERS.time("run_staged"):
                run()
        print(f"run {i}: {time.perf_counter() - t0:.3f}s", flush=True)

    print(f"\n{'stage':<24}{'n':>4}{'p50 ms':>10}{'p95 ms':>10}")
    for stage, s in sorted(TIMERS.summary().items()):
        print(f"{stage:<24}{s['count']:>4}{s['p50_s'] * 1e3:>10.1f}"
              f"{s['p95_s'] * 1e3:>10.1f}")
    if args.trace:
        print(f"\ntrace written to {trace_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
