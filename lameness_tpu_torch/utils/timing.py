"""Stage timing (port of ``lameness_tpu/utils/timing.py``).

Every pipeline stage records wall time into a process-wide registry; the
stage names are the JAX package's (``decode``, ``transfer``,
``engine_stream``, ``readback``, ``write_results``, ...).  The device trace
of the JAX module (``jax.profiler``) is not ported yet: on the card,
torch.profiler takes its place.
"""
from __future__ import annotations

import contextlib
import json
import threading
import time
from collections import defaultdict, deque
from pathlib import Path
from typing import Dict, Iterator

import numpy as np


class StageTimers:
    """Thread-safe rolling stage timings (last N samples per stage)."""

    def __init__(self, window: int = 200):
        self._samples: Dict[str, deque] = defaultdict(
            lambda: deque(maxlen=window))
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def time(self, stage: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self._samples[stage].append(dt)

    def record(self, stage: str, seconds: float) -> None:
        with self._lock:
            self._samples[stage].append(seconds)

    def reset(self) -> None:
        with self._lock:
            self._samples.clear()

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        with self._lock:
            for stage, samples in self._samples.items():
                if not samples:
                    continue
                a = np.asarray(samples)
                out[stage] = {
                    "count": int(len(a)),
                    "mean_s": float(a.mean()),
                    "p50_s": float(np.median(a)),
                    "p95_s": float(np.percentile(a, 95)),
                    "last_s": float(a[-1]),
                }
        return out

    def dump(self, path: Path) -> None:
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)


# process-wide registry the driver shares
TIMERS = StageTimers()
