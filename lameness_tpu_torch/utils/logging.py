"""Structured JSON-lines logging (port of ``lameness_tpu/utils/logging.py``).

Every event is one JSON object on stderr (and optionally a file):
``{"ts": ..., "level": "info", "service": "lameness.driver", "event":
"stage.complete", "video_id": ..., ...}``.  ``LAMENESS_LOG_LEVEL``
(debug/info/warning/error) and ``LAMENESS_LOG_FILE`` control the sink;
the default level is info.  The logger tree is the JAX package's
(``lameness``): a process that loads both configures it once.
"""
from __future__ import annotations

import json
import logging
import os
import sys
from typing import Any, Optional


class JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": round(record.created, 3),
            "level": record.levelname.lower(),
            "service": record.name,
            "event": record.getMessage(),
        }
        fields = getattr(record, "fields", None)
        if fields:
            out.update(fields)
        if record.exc_info and record.exc_info[0] is not None:
            out["exc"] = repr(record.exc_info[1])[:300]
        return json.dumps(out, default=str)


def _configure_root() -> None:
    root = logging.getLogger("lameness")
    if root.handlers:
        return
    level = os.environ.get("LAMENESS_LOG_LEVEL", "info").upper()
    root.setLevel(getattr(logging, level, logging.INFO))
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(JsonFormatter())
    root.addHandler(handler)
    log_file = os.environ.get("LAMENESS_LOG_FILE")
    if log_file:
        fh = logging.FileHandler(log_file)
        fh.setFormatter(JsonFormatter())
        root.addHandler(fh)
    root.propagate = False


class StructuredLogger:
    """Thin wrapper: ``log.info("stage.complete", video_id=..., s=1.2)``."""

    def __init__(self, service: str):
        _configure_root()
        self._log = logging.getLogger(f"lameness.{service}")

    def _emit(self, level: int, event: str, **fields: Any) -> None:
        self._log.log(level, event, extra={"fields": fields})

    def debug(self, event: str, **fields: Any) -> None:
        self._emit(logging.DEBUG, event, **fields)

    def info(self, event: str, **fields: Any) -> None:
        self._emit(logging.INFO, event, **fields)

    def warning(self, event: str, **fields: Any) -> None:
        self._emit(logging.WARNING, event, **fields)

    def error(self, event: str, exc: Optional[BaseException] = None,
              **fields: Any) -> None:
        if exc is not None:
            fields["exc"] = repr(exc)[:300]
        self._emit(logging.ERROR, event, **fields)


def get_logger(service: str) -> StructuredLogger:
    return StructuredLogger(service)
