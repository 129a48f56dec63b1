"""Relational store with the reference's exact table contract (port of
``lameness_tpu/io/db.py``, copied: SQLite, or Postgres over the port's
wire driver ``io/pg_wire.py``).

The reference runs Postgres with 14 ORM models
(``admin-interface/backend/app/database.py:43-335`` mirrored by
``scripts/init_db.sql``).  The contract is the schema + the query set
the routers make — this module renders both in SQLite via stdlib
``sqlite3`` behind a thread-safe ``Database`` facade, every helper
exercised by tests.  A Postgres deployment is a driver swap on this
facade: ``Database(path, driver=...)`` accepts any DB-API driver
object (``.connect(path)`` + ``.paramstyle``); ``?`` placeholders are
rewritten to ``%s`` for format/pyformat drivers and column reflection
switches from ``PRAGMA`` to ``information_schema``.  The SQL is a
deliberately portable subset (TEXT/INTEGER/REAL columns, standard
CHECK/REFERENCES, no sqlite-only syntax).  ``io/pg_wire.py`` implements
the Postgres v3 wire protocol (client driver + SQLite-backed wire server,
the ``pg-server`` subcommand); ``open_database()`` picks the driver from
the URL scheme (the reference's DATABASE_URL shape, database.py:16).

Tables: users, sessions, processing_jobs, videos, gold_tasks, rater_stats,
service_heartbeats, video_elo_ratings, pairwise_comparisons, elo_history,
hierarchy_snapshots, cow_identities, track_history, lameness_records.
"""
from __future__ import annotations

import json
import sqlite3
import threading
import uuid
from datetime import datetime, timezone
from pathlib import Path
from typing import Any, Dict, List, Optional

_SCHEMA = """
CREATE TABLE IF NOT EXISTS users (
    id TEXT PRIMARY KEY,
    email TEXT UNIQUE NOT NULL,
    username TEXT UNIQUE NOT NULL,
    password_hash TEXT NOT NULL,
    role TEXT NOT NULL DEFAULT 'rater' CHECK (role IN ('admin','researcher','rater')),
    is_active INTEGER DEFAULT 1,
    rater_tier TEXT,
    created_at TEXT,
    last_login TEXT
);
CREATE TABLE IF NOT EXISTS sessions (
    id TEXT PRIMARY KEY,
    user_id TEXT NOT NULL REFERENCES users(id) ON DELETE CASCADE,
    token_hash TEXT NOT NULL,
    expires_at TEXT NOT NULL,
    created_at TEXT
);
CREATE TABLE IF NOT EXISTS processing_jobs (
    job_id TEXT PRIMARY KEY,
    video_id TEXT NOT NULL,
    status TEXT DEFAULT 'pending' CHECK (status IN
        ('pending','processing','completed','failed','cancelled')),
    priority INTEGER DEFAULT 0,
    progress REAL DEFAULT 0.0,
    current_pipeline TEXT,
    created_at TEXT,
    started_at TEXT,
    completed_at TEXT,
    error_message TEXT,
    user_id TEXT REFERENCES users(id)
);
CREATE INDEX IF NOT EXISTS idx_jobs_video ON processing_jobs(video_id);
CREATE TABLE IF NOT EXISTS videos (
    id TEXT PRIMARY KEY,
    filename TEXT NOT NULL,
    original_filename TEXT,
    file_size INTEGER NOT NULL,
    storage_backend TEXT NOT NULL DEFAULT 'local',
    s3_key TEXT,
    file_path TEXT,
    label INTEGER,
    label_confidence TEXT,
    status TEXT DEFAULT 'uploaded',
    has_analysis INTEGER DEFAULT 0,
    has_annotated INTEGER DEFAULT 0,
    duration REAL, fps REAL, width INTEGER, height INTEGER,
    frame_count INTEGER,
    uploaded_by TEXT REFERENCES users(id),
    uploaded_at TEXT,
    processed_at TEXT
);
CREATE INDEX IF NOT EXISTS idx_videos_status ON videos(status);
CREATE INDEX IF NOT EXISTS idx_videos_label ON videos(label);
CREATE TABLE IF NOT EXISTS gold_tasks (
    id TEXT PRIMARY KEY,
    video_id_1 TEXT NOT NULL,
    video_id_2 TEXT NOT NULL,
    correct_winner INTEGER NOT NULL CHECK (correct_winner IN (0,1,2)),
    correct_degree INTEGER DEFAULT 2 CHECK (correct_degree BETWEEN 1 AND 3),
    difficulty TEXT DEFAULT 'medium' CHECK (difficulty IN ('easy','medium','hard')),
    description TEXT, hint TEXT,
    is_tutorial INTEGER DEFAULT 0,
    tutorial_order INTEGER,
    created_by TEXT REFERENCES users(id),
    is_active INTEGER DEFAULT 1,
    created_at TEXT
);
CREATE TABLE IF NOT EXISTS rater_stats (
    id TEXT PRIMARY KEY,
    user_id TEXT UNIQUE NOT NULL REFERENCES users(id) ON DELETE CASCADE,
    total_comparisons INTEGER DEFAULT 0,
    gold_task_accuracy REAL DEFAULT 0.0,
    agreement_rate REAL DEFAULT 0.0,
    weight REAL DEFAULT 1.0,
    tier TEXT DEFAULT 'bronze',
    last_activity TEXT,
    updated_at TEXT
);
CREATE TABLE IF NOT EXISTS service_heartbeats (
    id TEXT PRIMARY KEY,
    service_name TEXT UNIQUE NOT NULL,
    status TEXT DEFAULT 'unknown',
    last_heartbeat TEXT,
    active_jobs INTEGER DEFAULT 0,
    success_count INTEGER DEFAULT 0,
    error_count INTEGER DEFAULT 0,
    last_error TEXT,
    extra_data TEXT
);
CREATE TABLE IF NOT EXISTS video_elo_ratings (
    id TEXT PRIMARY KEY,
    video_id TEXT UNIQUE NOT NULL,
    elo_rating REAL DEFAULT 1500.0,
    elo_uncertainty REAL DEFAULT 350.0,
    wins INTEGER DEFAULT 0,
    losses INTEGER DEFAULT 0,
    ties INTEGER DEFAULT 0,
    total_comparisons INTEGER DEFAULT 0,
    win_probability REAL DEFAULT 0.5,
    normalized_score REAL,
    rank_position INTEGER,
    created_at TEXT,
    updated_at TEXT
);
CREATE TABLE IF NOT EXISTS pairwise_comparisons (
    id TEXT PRIMARY KEY,
    video_id_1 TEXT NOT NULL,
    video_id_2 TEXT NOT NULL,
    winner INTEGER NOT NULL CHECK (winner IN (0,1,2)),
    degree INTEGER DEFAULT 1 CHECK (degree BETWEEN 0 AND 3),
    confidence TEXT DEFAULT 'confident',
    rater_id TEXT REFERENCES users(id),
    rater_weight REAL DEFAULT 1.0,
    is_gold_task INTEGER DEFAULT 0,
    created_at TEXT
);
CREATE INDEX IF NOT EXISTS idx_pc_v1 ON pairwise_comparisons(video_id_1);
CREATE INDEX IF NOT EXISTS idx_pc_v2 ON pairwise_comparisons(video_id_2);
CREATE TABLE IF NOT EXISTS elo_history (
    id TEXT PRIMARY KEY,
    video_id TEXT NOT NULL,
    elo_rating REAL NOT NULL,
    comparison_count INTEGER NOT NULL,
    recorded_at TEXT
);
CREATE TABLE IF NOT EXISTS hierarchy_snapshots (
    id TEXT PRIMARY KEY,
    name TEXT NOT NULL,
    description TEXT,
    total_videos INTEGER NOT NULL,
    total_comparisons INTEGER NOT NULL,
    steepness REAL,
    steepness_std REAL,
    inter_rater_reliability REAL,
    ranking_data TEXT NOT NULL,
    created_by TEXT REFERENCES users(id),
    created_at TEXT
);
CREATE TABLE IF NOT EXISTS cow_identities (
    id TEXT PRIMARY KEY,
    cow_id TEXT UNIQUE NOT NULL,
    tag_number TEXT,
    total_sightings INTEGER DEFAULT 0,
    first_seen TEXT,
    last_seen TEXT,
    embedding_version TEXT DEFAULT 'dinov3-base',
    notes TEXT,
    is_active INTEGER DEFAULT 1
);
CREATE TABLE IF NOT EXISTS track_history (
    id TEXT PRIMARY KEY,
    video_id TEXT NOT NULL,
    track_id INTEGER NOT NULL,
    cow_id TEXT REFERENCES cow_identities(id),
    reid_confidence REAL,
    start_frame INTEGER,
    end_frame INTEGER,
    total_frames INTEGER,
    avg_confidence REAL,
    created_at TEXT
);
CREATE INDEX IF NOT EXISTS idx_th_video ON track_history(video_id);
CREATE TABLE IF NOT EXISTS lameness_records (
    id TEXT PRIMARY KEY,
    cow_id TEXT NOT NULL REFERENCES cow_identities(id),
    video_id TEXT NOT NULL,
    observation_date TEXT,
    fusion_score REAL, tleap_score REAL, tcn_score REAL,
    transformer_score REAL, gnn_score REAL, graph_transformer_score REAL,
    ml_ensemble_score REAL,
    is_lame INTEGER, confidence REAL, severity_level TEXT,
    human_validated INTEGER DEFAULT 0,
    human_label INTEGER,
    validator_id TEXT REFERENCES users(id),
    validation_date TEXT
);
CREATE INDEX IF NOT EXISTS idx_lr_cow ON lameness_records(cow_id);
"""

TABLES = [
    "users", "sessions", "processing_jobs", "videos", "gold_tasks",
    "rater_stats", "service_heartbeats", "video_elo_ratings",
    "pairwise_comparisons", "elo_history", "hierarchy_snapshots",
    "cow_identities", "track_history", "lameness_records",
]


def _now() -> str:
    return datetime.now(timezone.utc).isoformat()


class Database:
    def __init__(self, path: Path | str = ":memory:", driver=None):
        """``driver``: DB-API-style object with ``.connect(path)`` and
        ``.paramstyle`` (default: stdlib sqlite3).  Postgres drivers
        (paramstyle format/pyformat, e.g. psycopg) get ``?`` → ``%s``
        placeholder rewriting and information_schema reflection."""
        self.path = str(path)
        self._driver = driver if driver is not None else sqlite3
        self._qmark = getattr(self._driver, "paramstyle", "qmark") == "qmark"
        self._local = threading.local()
        self._lock = threading.Lock()
        conn = self._conn()
        if hasattr(conn, "executescript"):
            conn.executescript(_SCHEMA)
        else:
            for stmt in _SCHEMA.split(";"):
                if stmt.strip():
                    conn.execute(stmt)
            conn.commit()

    def _conn(self):
        if not hasattr(self._local, "conn"):
            if self._driver is sqlite3:
                conn = sqlite3.connect(self.path, check_same_thread=False)
                conn.row_factory = sqlite3.Row
                conn.execute("PRAGMA foreign_keys=ON")
            else:
                conn = self._driver.connect(self.path)
            self._local.conn = conn
        return self._local.conn

    def _sql(self, sql: str) -> str:
        """Rewrite qmark placeholders for format/pyformat drivers."""
        return sql if self._qmark else sql.replace("?", "%s")

    def execute(self, sql: str, params: tuple = ()):
        with self._lock:
            cur = self._conn().execute(self._sql(sql), params)
            self._conn().commit()
            return cur

    def query(self, sql: str, params: tuple = ()) -> List[Dict[str, Any]]:
        cur = self._conn().execute(self._sql(sql), params)
        rows = cur.fetchall()
        if rows and not hasattr(rows[0], "keys"):   # tuple-row drivers
            names = [d[0] for d in cur.description]
            return [dict(zip(names, r)) for r in rows]
        return [dict(r) for r in rows]

    def one(self, sql: str, params: tuple = ()) -> Optional[Dict[str, Any]]:
        rows = self.query(sql, params)
        return rows[0] if rows else None

    # -- generic helpers -----------------------------------------------------
    def insert(self, table: str, row: Dict[str, Any]) -> str:
        row = dict(row)
        pk = "job_id" if table == "processing_jobs" else "id"
        row.setdefault(pk, str(uuid.uuid4()))
        if "created_at" in self._columns(table):
            row.setdefault("created_at", _now())
        cols = ", ".join(row)
        ph = ", ".join("?" * len(row))
        self.execute(f"INSERT INTO {table} ({cols}) VALUES ({ph})",
                     tuple(_coerce(v) for v in row.values()))
        return row[pk]

    def update(self, table: str, pk_value: str, fields: Dict[str, Any],
               pk: str = "id") -> None:
        if not fields:       # "SET  WHERE" is a syntax error -> 500s
            return
        sets = ", ".join(f"{k}=?" for k in fields)
        self.execute(f"UPDATE {table} SET {sets} WHERE {pk}=?",
                     tuple(_coerce(v) for v in fields.values()) + (pk_value,))

    def _columns(self, table: str) -> List[str]:
        if self._driver is sqlite3:
            return [r["name"]
                    for r in self.query(f"PRAGMA table_info({table})")]
        # portable reflection for non-sqlite drivers (Postgres et al.)
        return [r["column_name"] for r in self.query(
            "SELECT column_name FROM information_schema.columns "
            "WHERE table_name=?", (table,))]

    # -- domain helpers the routers need -------------------------------------
    def upsert_heartbeat(self, service_name: str, status: str = "healthy",
                         active_jobs: int = 0, success_count: int = 0,
                         error_count: int = 0,
                         last_error: Optional[str] = None,
                         extra: Optional[Dict] = None) -> None:
        """routers/pipeline.py:407-458."""
        existing = self.one(
            "SELECT id FROM service_heartbeats WHERE service_name=?",
            (service_name,))
        fields = dict(status=status, last_heartbeat=_now(),
                      active_jobs=active_jobs, success_count=success_count,
                      error_count=error_count, last_error=last_error,
                      extra_data=json.dumps(extra) if extra else None)
        if existing:
            self.update("service_heartbeats", existing["id"], fields)
        else:
            self.insert("service_heartbeats",
                        {"service_name": service_name, **fields})

    def get_or_create_elo(self, video_id: str) -> Dict[str, Any]:
        row = self.one("SELECT * FROM video_elo_ratings WHERE video_id=?",
                       (video_id,))
        if row is None:
            self.insert("video_elo_ratings",
                        {"video_id": video_id, "updated_at": _now()})
            row = self.one("SELECT * FROM video_elo_ratings WHERE video_id=?",
                           (video_id,))
        return row

    def update_elo(self, video_id: str, rating: float, uncertainty: float,
                   outcome: str) -> None:
        row = self.get_or_create_elo(video_id)
        inc = {"win": ("wins", row["wins"] + 1),
               "loss": ("losses", row["losses"] + 1),
               "tie": ("ties", row["ties"] + 1)}[outcome]
        total = row["total_comparisons"] + 1
        wins = row["wins"] + (1 if outcome == "win" else 0)
        ties = row["ties"] + (1 if outcome == "tie" else 0)
        self.update("video_elo_ratings", row["id"], {
            "elo_rating": rating, "elo_uncertainty": uncertainty,
            inc[0]: inc[1],
            "total_comparisons": total,
            "win_probability": (wins + 0.5 * ties) / total,
            "updated_at": _now()})
        self.insert("elo_history", {
            "video_id": video_id, "elo_rating": rating,
            "comparison_count": row["total_comparisons"] + 1,
            "recorded_at": _now()})

    def get_or_create_cow(self, cow_id: str,
                          tag_number: Optional[str] = None) -> Dict[str, Any]:
        row = self.one("SELECT * FROM cow_identities WHERE cow_id=?",
                       (cow_id,))
        if row is None:
            self.insert("cow_identities", {
                "cow_id": cow_id, "tag_number": tag_number,
                "total_sightings": 0, "first_seen": _now(),
                "last_seen": _now()})
            row = self.one("SELECT * FROM cow_identities WHERE cow_id=?",
                           (cow_id,))
        return row

    def record_sighting(self, cow_id: str, video_id: str, track_id: int,
                        reid_confidence: float, start_frame: int,
                        end_frame: int, avg_confidence: float) -> None:
        cow = self.get_or_create_cow(cow_id)
        self.update("cow_identities", cow["id"], {
            "total_sightings": cow["total_sightings"] + 1,
            "last_seen": _now()})
        self.insert("track_history", {
            "video_id": video_id, "track_id": track_id, "cow_id": cow["id"],
            "reid_confidence": reid_confidence, "start_frame": start_frame,
            "end_frame": end_frame,
            "total_frames": end_frame - start_frame + 1,
            "avg_confidence": avg_confidence})

    def add_lameness_record(self, cow_id: str, video_id: str,
                            fusion_result: Dict[str, Any],
                            predictions: Dict[str, Any]) -> Optional[str]:
        """fusion-service/app/main.py:316-355 field mapping."""
        cow = self.one("SELECT * FROM cow_identities WHERE cow_id=?",
                       (cow_id,))
        if cow is None:
            return None
        p = lambda k, kk="probability": predictions.get(k, {}).get(kk)
        score = fusion_result.get("final_probability", 0.5)
        sev = ("healthy" if score < 0.3 else "mild" if score < 0.5
               else "moderate" if score < 0.7 else "severe")
        return self.insert("lameness_records", {
            "cow_id": cow["id"], "video_id": video_id,
            "observation_date": _now(),
            "fusion_score": fusion_result.get("final_probability"),
            "tleap_score": predictions.get("tleap", {}).get("lameness_score"),
            "tcn_score": p("tcn"), "transformer_score": p("transformer"),
            "gnn_score": p("gnn"),
            "graph_transformer_score": p("graph_transformer"),
            "ml_ensemble_score": p("ml"),
            "is_lame": int(fusion_result.get("final_prediction") == 1),
            "confidence": fusion_result.get("confidence"),
            "severity_level": sev})

    def lameness_history(self, cow_id: str) -> List[Dict[str, Any]]:
        return self.query(
            "SELECT lr.* FROM lameness_records lr "
            "JOIN cow_identities ci ON lr.cow_id = ci.id "
            "WHERE ci.cow_id=? ORDER BY lr.observation_date", (cow_id,))


def _coerce(v):
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, (dict, list)):
        return json.dumps(v)
    return v


def open_database(url_or_path: "Path | str" = ":memory:") -> Database:
    """Driver-dispatching constructor: a ``postgres://`` /
    ``postgresql://`` URL (the reference's DATABASE_URL shape,
    admin-interface/backend/app/database.py:16) opens the facade over the
    wire driver (``io/pg_wire.py``); anything else is a SQLite path."""
    s = str(url_or_path)
    if s.startswith(("postgres://", "postgresql://")):
        from . import pg_wire
        return Database(s, driver=pg_wire)
    return Database(url_or_path)
