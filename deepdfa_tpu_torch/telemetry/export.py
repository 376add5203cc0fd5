"""Exporters: Chrome trace-event JSON (loadable in Perfetto) and JSONL
(port of ``deepdfa_tpu/telemetry/export.py``).

The shard set under ``<run>/telemetry/`` is the source of truth;
``trace.json`` is a view generated from it in the Chrome trace-event
format, so ``chrome://tracing`` or https://ui.perfetto.dev render the
same events.

Layout: the primary process writes ``events.jsonl``; every child with an
inherited trace context writes ``events-<process>-<pid>.jsonl`` into the
same directory, and rotation seals either into
``<stem>.seg-NNNNNN.jsonl`` segments. Every file opens with a
``kind: "meta"`` record naming its emitter (pid and process), so the
merged Chrome view stamps the emitter's pid on every event and emits
``M``-phase ``process_name`` metadata, one named track group a process.

Reads skip and count what they cannot parse: a torn trailing row (a
child killed mid-append) costs that row, never the view.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Iterable, List, Optional, Tuple

META_KIND = "meta"

# Shard filenames: "events.jsonl" (primary) / "events-<proc>-<pid>.jsonl"
# (children); sealed segments insert ".seg-NNNNNN" before the extension.
# Process-name fragments are sanitized to [A-Za-z0-9_-], so the dot
# reliably separates the stem from the segment suffix.
_ACTIVE_RE = re.compile(r"^(events(?:-[A-Za-z0-9_-]+)?)\.jsonl$")
_SEGMENT_RE = re.compile(
    r"^(events(?:-[A-Za-z0-9_-]+)?)\.seg-(\d+)\.jsonl$")


def append_jsonl(path: str, record: Dict[str, Any]) -> None:
    """THE JSONL writer every telemetry-adjacent file goes through
    (``events.jsonl`` flushes batch their own writes; per-step profile
    records come one at a time)."""
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")


def read_events(events_path: str,
                stats: Optional[Dict[str, Any]] = None,
                ) -> List[Dict[str, Any]]:
    """One shard file's records, annotated and torn-row tolerant.

    Unparseable / non-object lines are skipped and counted (into
    ``stats["torn_rows"]`` when a stats dict is passed) — a child killed
    mid-append must cost its last row, never the read. Records after a
    ``meta`` header are annotated with the emitter's ``_pid`` /
    ``_process`` so downstream views carry real process identity; the
    meta records themselves stay in the list (``kind: "meta"`` — the
    Chrome exporter filters on kind).
    """
    out: List[Dict[str, Any]] = []
    torn = 0
    pid: Optional[int] = None
    process: Optional[str] = None
    with open(events_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                torn += 1
                continue
            if not isinstance(rec, dict):
                torn += 1
                continue
            if rec.get("kind") == META_KIND:
                if rec.get("pid") is not None:
                    pid = int(rec["pid"])
                    process = rec.get("process")
            elif pid is not None and "_pid" not in rec:
                rec["_pid"] = pid
                rec["_process"] = process
            out.append(rec)
    if stats is not None:
        stats["torn_rows"] = stats.get("torn_rows", 0) + torn
        if pid is not None:
            stats.setdefault("pid", pid)
            stats.setdefault("process", process)
    return out


def shard_files(telemetry_dir: str) -> Dict[str, List[str]]:
    """``{shard stem: [file paths, sealed segments first in sequence
    order, active file last]}`` for every shard under a run's telemetry
    directory."""
    groups: Dict[str, Dict[str, Any]] = {}
    try:
        names = sorted(os.listdir(telemetry_dir))
    except OSError:
        return {}
    for name in names:
        seg = _SEGMENT_RE.match(name)
        if seg is not None:
            g = groups.setdefault(seg.group(1), {"segs": [], "active": None})
            g["segs"].append((int(seg.group(2)), name))
            continue
        active = _ACTIVE_RE.match(name)
        if active is not None:
            g = groups.setdefault(active.group(1), {"segs": [],
                                                    "active": None})
            g["active"] = name
    out: Dict[str, List[str]] = {}
    for stem, g in sorted(groups.items()):
        ordered = [name for _, name in sorted(g["segs"])]
        if g["active"] is not None:
            ordered.append(g["active"])
        out[stem] = [os.path.join(telemetry_dir, n) for n in ordered]
    return out


def read_run_dir(run_dir: str
                 ) -> Tuple[List[Dict[str, Any]], List[Dict[str, Any]]]:
    """Merged, annotated events from EVERY shard (and sealed segment) of
    a run, sorted onto the one shared timeline, plus per-shard stats
    (process, pid, segment/torn-row/byte accounting)."""
    tdir = os.path.join(run_dir, "telemetry")
    events: List[Dict[str, Any]] = []
    shards: List[Dict[str, Any]] = []
    for stem, files in shard_files(tdir).items():
        stats: Dict[str, Any] = {
            "shard": stem,
            "files": len(files),
            "segments": sum(1 for p in files if ".seg-" in
                            os.path.basename(p)),
            "torn_rows": 0,
            "bytes": 0,
            "events": 0,
        }
        for path in files:
            try:
                stats["bytes"] += os.path.getsize(path)
            except OSError:
                pass
            recs = read_events(path, stats=stats)
            stats["events"] += sum(1 for r in recs
                                   if r.get("kind") != META_KIND)
            events.extend(recs)
        shards.append(stats)

    def _ts(rec: Dict[str, Any]) -> float:
        try:
            return float(rec.get("ts", 0.0))
        except (TypeError, ValueError):
            return 0.0

    events.sort(key=_ts)
    return events, shards


def events_to_chrome_trace(events: Iterable[Dict[str, Any]],
                           wall_start: Optional[float] = None,
                           default_pid: Optional[int] = None,
                           ) -> Dict[str, Any]:
    """Telemetry records -> Chrome trace-event document.

    Spans become complete (``ph: "X"``) events, instants become
    ``ph: "i"`` — both with microsecond timestamps, which is what the
    format specifies and Perfetto expects. Every event carries its
    EMITTER's pid (the ``_pid`` annotation from the shard's meta header,
    never the reader's ``os.getpid()``), and each distinct emitter
    gets an ``M``-phase ``process_name`` metadata event so the merged
    view renders named per-process track groups. ``default_pid`` covers
    legacy un-annotated records only.
    """
    if default_pid is None:
        default_pid = os.getpid()
    trace_events: List[Dict[str, Any]] = []
    procs: Dict[int, Optional[str]] = {}
    for rec in events:
        if rec.get("kind") == META_KIND:
            if rec.get("pid") is not None:
                procs.setdefault(int(rec["pid"]), rec.get("process"))
            continue
        pid = int(rec.get("_pid", default_pid))
        if rec.get("_process") is not None:
            procs.setdefault(pid, rec["_process"])
        else:
            procs.setdefault(pid, None)
        base: Dict[str, Any] = {
            "name": rec.get("name", "?"),
            "pid": pid,
            "tid": rec.get("tid", 0),
            "ts": float(rec.get("ts", 0.0)) * 1e6,
            "cat": rec.get("kind", "event"),
        }
        args = dict(rec.get("attrs") or {})
        for k in ("host_ms", "fenced", "error", "parent", "depth"):
            if k in rec:
                args[k] = rec[k]
        if args:
            base["args"] = args
        if rec.get("kind") == "span":
            base["ph"] = "X"
            base["dur"] = float(rec.get("dur_ms", 0.0)) * 1e3
        else:
            base["ph"] = "i"
            base["s"] = "t"  # thread-scoped instant
        trace_events.append(base)
    metadata = [
        {"ph": "M", "name": "process_name", "pid": pid, "tid": 0, "ts": 0,
         "args": {"name": name if name is not None else f"pid {pid}"}}
        for pid, name in sorted(procs.items())
    ]
    doc: Dict[str, Any] = {
        "traceEvents": metadata + trace_events,
        "displayTimeUnit": "ms",
    }
    if wall_start is not None:
        doc["otherData"] = {"wall_start_unix_s": wall_start}
    return doc


def _write_trace_doc(doc: Dict[str, Any], trace_path: str) -> int:
    # Pid-unique scratch: every process sharing a run dir may rewrite the
    # merged trace at its own end_run, and two writers racing one ".tmp"
    # name lose it under the other's replace.
    tmp = f"{trace_path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, trace_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return len(doc["traceEvents"])


def write_chrome_trace(events_path: str, trace_path: str,
                       wall_start: Optional[float] = None) -> int:
    """ONE shard file -> trace.json; returns the trace-event count.
    (Runs with children should use :func:`write_merged_trace`.)"""
    events = read_events(events_path) if os.path.exists(events_path) else []
    doc = events_to_chrome_trace(events, wall_start=wall_start)
    return _write_trace_doc(doc, trace_path)


def write_merged_trace(run_dir: str, trace_path: Optional[str] = None,
                       wall_start: Optional[float] = None) -> int:
    """Every shard and sealed segment of a run -> ONE ``trace.json``
    with per-emitter pids and named processes; returns the trace-event
    count. Idempotent and callable while children's shards sit on disk
    after they exited: the one view for auditing a cross-process
    drain from one merged timeline."""
    events, _ = read_run_dir(run_dir)
    if wall_start is None:
        metas = [e for e in events if e.get("kind") == META_KIND
                 and e.get("wall_start") is not None]
        if metas:
            wall_start = float(min(m["wall_start"] for m in metas))
    doc = events_to_chrome_trace(events, wall_start=wall_start)
    if trace_path is None:
        trace_path = os.path.join(run_dir, "telemetry", "trace.json")
    return _write_trace_doc(doc, trace_path)
