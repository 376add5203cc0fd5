"""The port's telemetry core (``deepdfa_tpu_torch/telemetry``) against the
JAX package's on the CPU: the Prometheus text byte for byte after the
same operations, sketch states, quantiles, fitted ladders and predicted
waste on the same seeded values, the Chrome trace JSON of the same
events, SLO breaches over the same snapshots, rotation and retention
counts under small budgets, and the trace context and ``traceparent``
round trip across the two packages (a child of either package joins the
other's run). Then the port's own: span nesting, fences, ring drops,
the registry under threads, the no-op paths."""

import json
import os
import random
import subprocess
import sys
import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from deepdfa_tpu import telemetry as jtel
from deepdfa_tpu.telemetry import context as jctx
from deepdfa_tpu.telemetry import export as jexport
from deepdfa_tpu.telemetry import registry as jregistry
from deepdfa_tpu.telemetry import sketch as jsketch
from deepdfa_tpu.telemetry import slo as jslo
from deepdfa_tpu_torch import telemetry as ptel
from deepdfa_tpu_torch.telemetry import context as pctx
from deepdfa_tpu_torch.telemetry import export as pexport
from deepdfa_tpu_torch.telemetry import registry as pregistry
from deepdfa_tpu_torch.telemetry import sketch as psketch
from deepdfa_tpu_torch.telemetry import slo as pslo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_run_state():
    """No test leaks an active run or an enabled override (both packages'
    run state is process-wide)."""
    for tel in (jtel, ptel):
        tel.end_run()
        tel.set_enabled(None)
    yield
    for tel in (jtel, ptel):
        tel.end_run()
        tel.set_enabled(None)


def _events(run_dir):
    path = os.path.join(run_dir, "telemetry", "events.jsonl")
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


# ---------------------------------------------------------------------------
# Registry: the exposition byte for byte
# ---------------------------------------------------------------------------


def _registry_script(mod, seed):
    """The same seeded operations on a fresh registry of ``mod``."""
    rng = np.random.default_rng(seed)
    reg = mod.Registry()
    for i in range(12):
        reg.counter(f"c{i % 4}_total").inc(int(rng.integers(0, 5)))
        reg.counter("f_total").inc(float(rng.random()))
        reg.gauge(f"g{i % 3}").set(float(rng.normal()))
        reg.gauge("depth").inc(int(rng.integers(-2, 3)))
        for v in rng.exponential(10.0, size=7):
            reg.histogram(f"h{i % 2}_ms", window=16).observe(float(v))
        reg.sketch("traffic_shape_serve_gnn_nodes").observe(
            int(rng.integers(1, 600)))
    extra = {"serve_latency_p99_ms": float(rng.random()), "serve_n": 3,
             "serve flag": True, "serve_name": "x", "p99 ms": 1.5}
    return reg, extra


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prometheus_text_matches_the_reference_byte_for_byte(seed):
    preg, extra = _registry_script(pregistry, seed)
    jreg, jextra = _registry_script(jregistry, seed)
    assert preg.prometheus_text(extra=extra) == \
        jreg.prometheus_text(extra=jextra)
    assert preg.snapshot() == jreg.snapshot()
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert preg.histogram("h0_ms").quantile(q) == \
            jreg.histogram("h0_ms").quantile(q)


def test_registry_kind_conflict_and_sanitize():
    reg = pregistry.Registry()
    reg.counter("a_total").inc(2)
    with pytest.raises(TypeError):
        reg.gauge("a_total")
    with pytest.raises(ValueError):
        reg.counter("bad name")
    with pytest.raises(ValueError):
        reg.counter("c_total").inc(-1)
    for raw in ("reason:v1", "9lives", "", "a-b.c", "ok_name"):
        assert pregistry.sanitize(raw) == jregistry.sanitize(raw)
    text = reg.prometheus_text(extra={"p99 ms": 1.5})
    assert "# TYPE deepdfa_a_total counter" in text
    assert "deepdfa_a_total 2" in text and "deepdfa_p99_ms 1.5" in text


def test_registry_exact_under_concurrent_bumps():
    from deepdfa_tpu_torch.core.metrics import ServingStats

    stats = ServingStats(latency_window=64, replica="r3")
    reg = ptel.REGISTRY
    c0 = reg.counter("serve_submitted_total").value
    r0 = reg.counter("serve_r3_submitted_total").value
    h0 = reg.histogram("serve_latency_ms").value["count"]
    n_threads, per_thread = 8, 250

    def hammer():
        for _ in range(per_thread):
            stats.bump("submitted")
            stats.observe_latency(0.001)

    threads = [threading.Thread(target=hammer) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    n = n_threads * per_thread
    assert stats.submitted == n
    assert reg.counter("serve_submitted_total").value - c0 == n
    assert reg.counter("serve_r3_submitted_total").value - r0 == n
    assert reg.histogram("serve_latency_ms").value["count"] - h0 == n


def test_serving_and_ingest_stats_publish_the_reference_series(
        monkeypatch):
    from deepdfa_tpu.core import metrics as jmetrics
    from deepdfa_tpu_torch.core import metrics as pmetrics

    def drive(metrics, reg):
        # A registry of its own, so the process registry keeps its counts.
        monkeypatch.setattr(metrics, "REGISTRY", reg)
        stats = metrics.ServingStats(latency_window=8, replica="r1")
        for name in ("submitted", "completed", "cache_misses"):
            stats.bump(name, by=3)
        stats.observe_latency(0.25)
        stats.record_batch(3, 4, lane="gnn", elems_used=90,
                           elems_per_slot=64, elems_budget=512)
        stats.record_batch(2, 2)
        metrics.IngestStats().bump("cache", "reason:v1", by=3)
        return reg.prometheus_text()

    ptext = drive(pmetrics, pregistry.Registry())
    jtext = drive(jmetrics, jregistry.Registry())
    assert ptext == jtext
    assert "deepdfa_ingest_cache_reason_v1_total 3" in ptext
    assert "deepdfa_serve_r1_batches_total 2" in ptext


# ---------------------------------------------------------------------------
# Sketches: states, quantiles, ladders, waste
# ---------------------------------------------------------------------------


def _values(seed, n=500, hi=3000):
    rng = np.random.default_rng(seed)
    return [int(v) for v in np.concatenate([
        rng.integers(1, 64, size=n // 2),
        rng.lognormal(4.0, 1.2, size=n - n // 2).astype(np.int64) + 1,
        [hi, 1 << 25, 0]])]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_sketch_states_quantiles_and_ladders_match_the_reference(seed):
    vals = _values(seed)
    for v in vals[:200:7] + [1, 8, 9, 63, 64, 65, 1 << 24, 1 << 26]:
        assert psketch.bucket_index(v) == jsketch.bucket_index(v)
        i = psketch.bucket_index(v)
        assert psketch.bucket_value(i) == jsketch.bucket_value(i)
    pst, jst = psketch.state_from_values(vals), jsketch.state_from_values(vals)
    assert pst == jst
    psk, jsk = psketch.ShapeSketch("x"), jsketch.ShapeSketch("x")
    for v in vals:
        psk.observe(v)
        jsk.observe(v)
    assert psk.state() == jsk.state() == {
        k: pst[k] for k in ("count", "total", "min", "max", "bins")}
    assert psk.value == jsk.value
    for q in (0.0, 0.1, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert psketch.quantile_from_bins(pst["bins"], q) == \
            jsketch.quantile_from_bins(jst["bins"], q)
    assert psketch.summarize_state(pst) == jsketch.summarize_state(jst)
    chunks = [vals[i::3] for i in range(3)]
    merged = psketch.merge_states(
        [psketch.state_from_values(c) for c in chunks])
    assert merged == jsketch.merge_states(
        [jsketch.state_from_values(c) for c in chunks]) == pst
    ladder = psketch.fit_ladder(pst)
    assert ladder == jsketch.fit_ladder(jst)
    assert ladder == sorted(set(ladder))
    for rungs in (ladder, [64, 128, 1 << 24], [ladder[-1]], []):
        assert psketch.predicted_waste_pct(pst, rungs) == \
            jsketch.predicted_waste_pct(jst, rungs)


def test_sketch_merge_is_exact_in_any_order():
    rng = random.Random(7)
    chunks = [[rng.randint(1, 10_000) for _ in range(200)]
              for _ in range(3)]
    a, b, c = (psketch.state_from_values(ch) for ch in chunks)
    m1 = psketch.merge_states([psketch.merge_states([a, b]), c])
    m2 = psketch.merge_states([a, psketch.merge_states([b, c])])
    m3 = psketch.merge_states([c, a, b])
    assert m1 == m2 == m3 == psketch.state_from_values(sum(chunks, []))


def test_capture_switch_and_unregistered_series():
    assert psketch.SHAPE_SERIES == jsketch.SHAPE_SERIES
    with pytest.raises(ValueError):
        psketch.observe_shape("traffic_shape_adhoc_thing", 1)
    name = "traffic_shape_serve_gnn_nodes"
    psketch.set_capture(False)
    try:
        before = ptel.REGISTRY.sketch(name).state()["count"]
        psketch.observe_shape(name, 10)
        assert ptel.REGISTRY.sketch(name).state()["count"] == before
    finally:
        psketch.set_capture(None)
    ptel.set_enabled(False)
    psketch.observe_shape(name, 10)
    assert ptel.REGISTRY.sketch(name).state()["count"] == before
    ptel.set_enabled(None)
    psketch.observe_shape(name, 10)
    assert ptel.REGISTRY.sketch(name).state()["count"] == before + 1


# ---------------------------------------------------------------------------
# Export: the Chrome trace of the same events
# ---------------------------------------------------------------------------


def _trace_events(seed):
    rng = np.random.default_rng(seed)
    out = [{"kind": "meta", "name": "telemetry.shard", "ts": 0.0,
            "pid": 4242, "process": "main", "wall_start": 1700000000.5}]
    for i in range(40):
        rec = {"kind": ("span", "event")[i % 2],
               "name": ("serve.flush", "serve.enqueue", "http.post")[i % 3],
               "ts": float(rng.random() * 10), "tid": int(i % 3),
               "_pid": (4242, 77)[i % 5 == 0],
               "_process": ("main", "child")[i % 5 == 0]}
        if rec["kind"] == "span":
            rec.update(dur_ms=float(rng.exponential(2.0)), depth=i % 2)
            if i % 4 == 0:
                rec.update(host_ms=0.5, fenced=True, parent="outer")
            if i % 7 == 0:
                rec["error"] = "FaultError"
        if i % 3:
            rec["attrs"] = {"n": int(rng.integers(1, 9)), "lane": "gnn"}
        out.append(rec)
    out.append({"kind": "span", "name": "legacy", "ts": 1.0,
                "dur_ms": 2.0})
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_chrome_trace_of_the_same_events_matches_the_reference(seed):
    events = _trace_events(seed)
    pdoc = pexport.events_to_chrome_trace(
        json.loads(json.dumps(events)), wall_start=12.5, default_pid=99)
    jdoc = jexport.events_to_chrome_trace(
        json.loads(json.dumps(events)), wall_start=12.5, default_pid=99)
    assert json.dumps(pdoc) == json.dumps(jdoc)
    assert {m["pid"] for m in pdoc["traceEvents"] if m["ph"] == "M"} == \
        {4242, 77, 99}


def test_run_trace_json_is_the_reference_view_of_its_events(tmp_path):
    """A port run's events.jsonl read by both packages' exporters gives
    one trace.json, and the file the port wrote at close is that view."""
    run = str(tmp_path / "run")
    with ptel.run_scope(run):
        with ptel.span("a", step=0):
            ptel.event("mark", x=1)
        with ptel.span("b") as sp:
            sp.fence(torch.ones(3))
    pdoc = json.load(open(os.path.join(run, "telemetry", "trace.json")))
    jout = str(tmp_path / "j.json")
    assert jexport.write_merged_trace(run, trace_path=jout) == \
        len(pdoc["traceEvents"])
    assert json.load(open(jout)) == pdoc
    events = pdoc["traceEvents"]
    metas = [e for e in events if e["ph"] == "M"]
    assert [(m["name"], m["args"]["name"]) for m in metas] == \
        [("process_name", "main")]
    assert all(e["pid"] == os.getpid() for e in events)
    for ev in events:
        assert ev["ph"] in ("X", "i", "M")
        if ev["ph"] == "X":
            assert ev["dur"] >= 0
        elif ev["ph"] == "i":
            assert ev["s"] == "t"
    (b,) = [e for e in events if e["name"] == "b"]
    assert b["args"]["fenced"] is True


def test_torn_trailing_row_is_skipped_and_counted(tmp_path):
    with ptel.run_scope(str(tmp_path)):
        for i in range(5):
            ptel.event("ok", i=i)
    path = os.path.join(str(tmp_path), "telemetry", "events.jsonl")
    with open(path, "a") as f:
        f.write('{"kind": "event", "name": "torn-mid')
    events, shards = pexport.read_run_dir(str(tmp_path))
    assert sum(1 for e in events if e.get("name") == "ok") == 5
    assert shards[0]["torn_rows"] == 1
    assert (events, shards) == jexport.read_run_dir(str(tmp_path))


# ---------------------------------------------------------------------------
# Rotation and retention
# ---------------------------------------------------------------------------


def _rotate_run(tel, run_dir, n):
    with tel.run_scope(run_dir):
        for i in range(n):
            tel.event("spam", i=i, pad="x" * 60)
            if i % 50 == 49:
                tel.flush()
        run = tel.current_run()
        counts = (run.rotations, run.segments_dropped)
    tdir = os.path.join(run_dir, "telemetry")
    segs = sorted(f for f in os.listdir(tdir) if ".seg-" in f)
    return counts, segs


@pytest.mark.parametrize("n,retain", [(300, 64 * 1024 * 1024), (1500, 8192)])
def test_rotation_and_retention_counts_match_the_reference(
        tmp_path, monkeypatch, n, retain):
    monkeypatch.setenv(ptel.spans.ROTATE_ENV_VAR, "4096")
    monkeypatch.setenv(ptel.spans.RETAIN_ENV_VAR, str(retain))
    before = ptel.REGISTRY.counter(
        "telemetry_retention_dropped_segments_total").value
    prot = ptel.REGISTRY.counter("telemetry_rotations_total").value
    pcounts, psegs = _rotate_run(ptel, str(tmp_path / "p"), n)
    jcounts, jsegs = _rotate_run(jtel, str(tmp_path / "j"), n)
    assert pcounts == jcounts and psegs == jsegs and psegs
    rotations, dropped = pcounts
    assert rotations >= 1
    assert ptel.REGISTRY.counter("telemetry_rotations_total").value \
        - prot == rotations
    assert ptel.REGISTRY.counter(
        "telemetry_retention_dropped_segments_total").value \
        - before == dropped
    events, _ = pexport.read_run_dir(str(tmp_path / "p"))
    spam = [int(e["attrs"]["i"]) for e in events if e.get("name") == "spam"]
    jevents, _ = jexport.read_run_dir(str(tmp_path / "j"))
    jspam = [int(e["attrs"]["i"]) for e in jevents
             if e.get("name") == "spam"]
    assert spam == jspam and max(spam) == n - 1
    if dropped:
        assert min(spam) > 0  # the oldest history went
    else:
        assert len(spam) == n


# ---------------------------------------------------------------------------
# SLO monitor: the same breaches over the same snapshots
# ---------------------------------------------------------------------------


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


SPEC = {"slos": [
    {"metric": "compiles.after_warmup", "max": 0},
    {"metric": "serve.request_ms_p99", "max": 50.0},
    {"metric": "serve_latency_ms.p99", "max": 20.0, "window_s": 5,
     "budget": 0.25},
    {"metric": "queue_depth", "min": 1, "window_s": 3, "budget": 0.5,
     "min_obs": 2},
    {"metric": "missing.metric", "max": 1},
]}


def _snapshots(seed, n=60):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        out.append({
            "compiles": {"after_warmup": int(rng.random() < 0.08)},
            "serve": {"request_ms_p99": float(rng.gamma(2.0, 18.0))},
            "serve_latency_ms": {"p99": float(rng.gamma(2.0, 8.0)),
                                 "count": i},
            "queue_depth": int(rng.integers(0, 3)),
        })
    return out


@pytest.mark.parametrize("spec", ["smoke", "chaos", "default", "spec"])
@pytest.mark.parametrize("seed", [0, 1])
def test_slo_monitor_breaches_match_the_reference(spec, seed):
    spec = SPEC if spec == "spec" else spec
    pclock, jclock = _Clock(), _Clock()
    pmon = pslo.SLOMonitor(spec, clock=pclock)
    jmon = jslo.SLOMonitor(spec, clock=jclock)
    rng = np.random.default_rng(seed + 100)
    n_breaches = 0
    for snap in _snapshots(seed):
        step = float(rng.exponential(0.7))
        pclock.t += step
        jclock.t += step
        snap = dict(snap, telemetry_drops=int(rng.random() < 0.05))
        pb, jb = pmon.observe(snap), jmon.observe(snap)
        assert pb == jb
        assert pmon.status() == jmon.status()
        n_breaches += len(pb)
    assert n_breaches == pmon.breaches_total > 0
    assert pmon.status()["breaches_total"] == jmon.breaches_total


def test_slo_specs_lookup_and_offline_gate_match_the_reference(tmp_path):
    assert pslo.BUILTIN_SPECS == jslo.BUILTIN_SPECS
    path = tmp_path / "spec.json"
    path.write_text(json.dumps(SPEC))
    assert pslo.load_spec(str(path)) == jslo.load_spec(str(path)) == SPEC
    for bad in ("nope", {"slos": []}, {"slos": [{"metric": "x"}]}):
        with pytest.raises(ValueError):
            pslo.load_spec(bad)
    for snap in _snapshots(3, n=8):
        for dotted in ("serve.request_ms_p99", "compiles.after_warmup",
                       "queue_depth", "serve_latency_ms", "a.b"):
            assert pslo.lookup(snap, dotted) == jslo.lookup(snap, dotted)
        for spec in ("smoke", SPEC,
                     {"slos": [{"metric": "missing", "max": 1,
                                "required": True}]}):
            assert pslo.evaluate_report(snap, spec) == \
                jslo.evaluate_report(snap, spec)


# ---------------------------------------------------------------------------
# Trace context: the wire format across the two packages
# ---------------------------------------------------------------------------


def test_trace_context_decodes_across_packages():
    kw = dict(run_dir="/runs/x", run_id="x-abc", process="fit-child",
              t0=12.5, wall_start=99.0, parent_process="main",
              trace_id="ab" * 16, parent_span="cd" * 8)
    pc, jc = pctx.TraceContext(**kw), jctx.TraceContext(**kw)
    assert pc.encode() == jc.encode()
    assert pctx.TraceContext.decode(jc.encode()) == pc
    assert jctx.TraceContext.decode(pc.encode()) == jc
    assert pctx.ENV_VAR == jctx.ENV_VAR == "DEEPDFA_TRACE_CONTEXT"
    assert pctx.TRACEPARENT_HEADER == jctx.TRACEPARENT_HEADER
    for name in ("ok", "a b/c", "", "x.y"):
        assert pctx.sanitize_process(name) == jctx.sanitize_process(name)


@pytest.mark.parametrize("payload", [
    "not json", "[1, 2]", "{}", '{"run_dir": "/x"}',
    '{"run_dir": "/x", "run_id": "r", "process": "p", "t0": "NaN-ish",'
    ' "wall_start": []}',
])
def test_malformed_context_payload_raises_value_error(payload):
    with pytest.raises(ValueError):
        pctx.TraceContext.decode(payload)


def test_inherited_malformed_env_is_counted_once_and_ignored(monkeypatch):
    monkeypatch.setenv(pctx.ENV_VAR, "{broken")
    pctx.reset_inherited()
    before = ptel.REGISTRY.counter("trace_ctx_malformed_total").value
    try:
        assert pctx.inherited() is None
        assert pctx.inherited() is None
        assert ptel.REGISTRY.counter(
            "trace_ctx_malformed_total").value - before == 1
    finally:
        pctx.reset_inherited()


def test_traceparent_round_trips_across_packages():
    rng = np.random.default_rng(5)
    for _ in range(20):
        tid = bytes(rng.integers(0, 256, 16, dtype=np.uint8)).hex()
        sid = bytes(rng.integers(0, 256, 8, dtype=np.uint8)).hex()
        header = pctx.make_traceparent(tid, sid)
        assert header == jctx.make_traceparent(tid, sid)
        assert jctx.parse_traceparent(header) == (tid, sid) == \
            pctx.parse_traceparent(jctx.make_traceparent(tid, sid))
    tid, sid = pctx.new_trace_id(), pctx.new_span_id()
    for bad in (None, "", "junk", f"00-{tid}-{sid}", f"01-{tid}-{sid}-01",
                f"00-{'0' * 32}-{sid}-01", f"00-{tid}-{'0' * 16}-01",
                f"00-{tid[:-1]}Z-{sid}-01", f"  00-{tid.upper()}-{sid}-01 "):
        assert pctx.parse_traceparent(bad) == jctx.parse_traceparent(bad)


def test_child_env_sets_context_only_under_active_run(tmp_path):
    env = pctx.child_env("worker", base={"PATH": "/bin",
                                         pctx.ENV_VAR: "stale"})
    assert pctx.ENV_VAR not in env and env["PATH"] == "/bin"
    with ptel.run_scope(str(tmp_path)):
        env = pctx.child_env("worker")
        ctx = pctx.TraceContext.decode(env[pctx.ENV_VAR])
        run = ptel.current_run()
        assert (ctx.process, ctx.run_id, ctx.t0) == \
            ("worker", run.run_id, run.t0)
        assert ctx.run_dir == os.path.abspath(str(tmp_path))


_CHILD = (
    "import time\n"
    "from {pkg} import telemetry\n"
    "with telemetry.run_scope('should-be-overridden'):\n"
    "    run = telemetry.current_run()\n"
    "    assert run.inherited and run.process == 'kid', run\n"
    "    t0 = telemetry.now()\n"
    "    time.sleep(0.01)\n"
    "    telemetry.record_span('serve.request', t0, rid=1,"
    " trace_id={trace_id!r}, trace_continued=True)\n"
    "    telemetry.event('kid.mark')\n")


@pytest.mark.parametrize("parent,child", [
    ("deepdfa_tpu_torch", "deepdfa_tpu_torch"),
    ("deepdfa_tpu", "deepdfa_tpu_torch"),
    ("deepdfa_tpu_torch", "deepdfa_tpu")])
def test_a_child_of_either_package_joins_the_others_run(tmp_path, parent,
                                                        child):
    """A child spawned with the parent's ``child_env`` writes its own
    shard of the parent's run, on the parent's clock, and the parent's
    merged trace.json names both processes."""
    tel = ptel if parent == "deepdfa_tpu_torch" else jtel
    ctx = pctx if parent == "deepdfa_tpu_torch" else jctx
    trace_id = pctx.new_trace_id()
    run = str(tmp_path / "run")
    with tel.run_scope(run):
        env = ctx.child_env("kid", PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
        proc = subprocess.run(
            [sys.executable, "-c", _CHILD.format(pkg=child,
                                                 trace_id=trace_id)],
            env=env, cwd=str(tmp_path), capture_output=True, text=True,
            timeout=240)
        assert proc.returncode == 0, proc.stderr[-2000:]
        tel.event("parent.mark")
    assert not os.path.exists(tmp_path / "should-be-overridden")
    for exp in (pexport, jexport):
        events, shards = exp.read_run_dir(run)
        assert {s["process"] for s in shards} == {"main", "kid"}
        (req,) = [e for e in events if e.get("name") == "serve.request"]
        assert req["_process"] == "kid" and req["_pid"] != os.getpid()
        assert req["attrs"]["trace_id"] == trace_id
        assert req["ts"] > 0  # on the parent's clock
    doc = json.load(open(os.path.join(run, "telemetry", "trace.json")))
    assert {m["args"]["name"] for m in doc["traceEvents"]
            if m["ph"] == "M"} == {"main", "kid"}


# ---------------------------------------------------------------------------
# Spans: nesting, fences, errors, rings, the no-op paths
# ---------------------------------------------------------------------------


def test_span_nesting_records_parent_and_depth(tmp_path):
    with ptel.run_scope(str(tmp_path)):
        with ptel.span("outer"):
            with ptel.span("inner", k=1):
                pass
        with ptel.span("solo"):
            pass
    by_name = {e["name"]: e for e in _events(str(tmp_path))
               if e["kind"] == "span"}
    assert by_name["inner"]["parent"] == "outer"
    assert by_name["inner"]["depth"] == 1 and by_name["outer"]["depth"] == 0
    assert by_name["inner"]["attrs"] == {"k": 1}
    assert "parent" not in by_name["solo"]
    assert by_name["inner"]["dur_ms"] <= by_name["outer"]["dur_ms"]
    assert by_name["inner"]["ts"] >= by_name["outer"]["ts"]


def test_a_cpu_fence_splits_host_and_total_and_waits_on_nothing(tmp_path):
    from deepdfa_tpu_torch.telemetry import spans

    assert spans.fence_events([torch.ones(2), {"a": (torch.zeros(1),)}]) \
        == []
    with ptel.run_scope(str(tmp_path)):
        with ptel.span("work") as sp:
            out = torch.ones(8) * 2
            sp.fence(out)
        with ptel.span("plain"):
            pass
    recs = {e["name"]: e for e in _events(str(tmp_path))
            if e["kind"] == "span"}
    assert recs["work"]["fenced"] is True
    assert 0.0 <= recs["work"]["host_ms"] <= recs["work"]["dur_ms"]
    assert "fenced" not in recs["plain"] and "host_ms" not in recs["plain"]
    assert sp.host_s is not None and sp.host_s <= sp.dur_s


def test_span_records_error_type(tmp_path):
    with ptel.run_scope(str(tmp_path)):
        with pytest.raises(ValueError):
            with ptel.span("boom"):
                raise ValueError("x")
    (rec,) = [e for e in _events(str(tmp_path)) if e["name"] == "boom"]
    assert rec["error"] == "ValueError"


def test_ring_overflow_drops_and_is_counted(tmp_path, monkeypatch):
    from deepdfa_tpu_torch.telemetry import spans as spans_mod

    # This thread's ring first, at the default capacity: made under the
    # tiny one, it would keep dropping in every later test of the process.
    spans_mod._ring()
    monkeypatch.setenv("DEEPDFA_TELEMETRY_RING", "4")
    before = ptel.drop_count()
    with ptel.run_scope(str(tmp_path)):
        def spam():
            for i in range(16):
                ptel.event("spam", i=i)

        t = threading.Thread(target=spam)
        t.start()
        t.join()
    assert ptel.drop_count() - before == 12
    events = _events(str(tmp_path))
    assert [e["name"] for e in events].count("spam") == 4
    (summary,) = [e for e in events if e["name"] == "telemetry.flush"]
    assert summary["attrs"]["drops"] == 12


def test_dead_thread_rings_are_reaped_on_flush(tmp_path):
    from deepdfa_tpu_torch.telemetry import spans as spans_mod

    with ptel.run_scope(str(tmp_path)):
        threads = [threading.Thread(target=lambda: ptel.event("t"))
                   for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        with spans_mod._RINGS_LOCK:
            n_before = len(spans_mod._RINGS)
        drops_before = ptel.drop_count()
        ptel.flush()
        with spans_mod._RINGS_LOCK:
            n_after = len(spans_mod._RINGS)
    assert n_after <= n_before - 4
    assert ptel.drop_count() == drops_before
    assert [e["name"] for e in _events(str(tmp_path))].count("t") == 4


def test_no_run_and_disabled_paths_are_noops(tmp_path):
    with ptel.span("x") as sp:
        pass
    assert sp.dur_s >= 0.0
    ptel.set_enabled(False)
    assert ptel.start_run(str(tmp_path)) is None
    with ptel.span("y") as sp:
        sp.fence(torch.ones(1))
    assert sp.dur_s == 0.0 and sp.host_s is None
    ptel.event("z")
    ptel.record_span("w", ptel.now())
    assert not os.path.exists(os.path.join(str(tmp_path), "telemetry"))


def test_nested_runs_are_refused_and_runs_start_fresh(tmp_path):
    run = str(tmp_path / "r")
    with ptel.run_scope(run):
        ptel.event("first")
        with pytest.raises(RuntimeError):
            ptel.start_run(run)
    with ptel.run_scope(run):
        ptel.event("second")
    names = [e["name"] for e in _events(run)]
    assert "second" in names and "first" not in names
    assert names[:2] == ["telemetry.shard", "telemetry.start"]
    assert names[-1] == "telemetry.flush"


def test_quarantine_events_land_in_the_run_as_the_references(tmp_path):
    from deepdfa_tpu.contracts import ContractError as JContractError
    from deepdfa_tpu.contracts import Quarantine as JQuarantine
    from deepdfa_tpu_torch.contracts import ContractError, Quarantine

    attrs = {}
    for name, tel, q_cls, err_cls in (
            ("port", ptel, Quarantine, ContractError),
            ("jax", jtel, JQuarantine, JContractError)):
        run = str(tmp_path / name / "run")
        with tel.run_scope(run):
            q = q_cls(tmp_path / name / "quarantine")
            q.put(err_cls("missing_field", "bad row", boundary="cache",
                          item_id=3))
        attrs[name] = [e["attrs"] for e in _events(run)
                       if e["name"] == "quarantine"]
    assert attrs["port"] == attrs["jax"] == [
        {"boundary": "cache", "reason": "missing_field", "item_id": 3}]
