"""Structured cluster events.

Parity: reference src/ray/util/event.h + dashboard/modules/event — daemons
emit typed, severity-tagged events (node death, actor failures, OOM kills,
spills) that operators can list after the fact. Here every process appends
JSON lines to its session `logs/events-<label>.jsonl`; `list_events()`
merges them time-ordered, and the CLI exposes `ray_tpu_torch events`.
"""

from __future__ import annotations

import json
import os
import threading
import time

_lock = threading.Lock()
_sink_path: str | None = None
_label = "unknown"

SEVERITIES = ("DEBUG", "INFO", "WARNING", "ERROR", "FATAL")


def configure(session_dir: str, label: str) -> None:
    """Called by daemons/drivers at startup; events before configure()
    are dropped (no session to attribute them to)."""
    global _sink_path, _label
    logs = os.path.join(session_dir, "logs")
    os.makedirs(logs, exist_ok=True)
    _sink_path = os.path.join(logs, f"events-{label}.jsonl")
    _label = label


def record(severity: str, source: str, message: str, **fields) -> None:
    """Append one structured event (no-op before configure())."""
    if _sink_path is None:
        return
    if severity not in SEVERITIES:
        severity = "INFO"
    evt = {"ts": time.time(), "severity": severity, "source": source,
           "label": _label, "pid": os.getpid(), "message": message}
    if fields:
        evt["fields"] = fields
    line = json.dumps(evt, default=str)
    with _lock:
        try:
            with open(_sink_path, "a") as f:
                f.write(line + "\n")
        except OSError:
            pass


def list_events(session_dir: str, *, min_severity: str = "DEBUG",
                source: str | None = None, limit: int = 1000) -> list[dict]:
    """Merged, time-ordered events from every process of a session."""
    floor = SEVERITIES.index(min_severity)
    out: list[dict] = []
    logs = os.path.join(session_dir, "logs")
    try:
        names = [n for n in os.listdir(logs)
                 if n.startswith("events-") and n.endswith(".jsonl")]
    except OSError:
        return []
    for name in names:
        try:
            with open(os.path.join(logs, name)) as f:
                for line in f:
                    try:
                        evt = json.loads(line)
                    except ValueError:
                        continue
                    if SEVERITIES.index(evt.get("severity", "INFO")) < floor:
                        continue
                    if source and evt.get("source") != source:
                        continue
                    out.append(evt)
        except OSError:
            continue
    out.sort(key=lambda e: e.get("ts", 0))
    return out[-limit:]
