"""The port's fault plan and preemption lifecycle
(``deepdfa_tpu_torch/resilience``) on the CPU: the fault plan fires as
the JAX package's does on the same seeded plans; the coordinator's
notice, drain accounting and hung-drain watchdog; the serving lame duck
(a simulated preemption armed through ``DEEPDFA_FAULT_PLAN``: every
admitted request answered, new ones 503 with Retry-After, ``/healthz``
"draining"); and ``cli serve`` in a subprocess drained by a real SIGTERM
to exit 75 with its lifecycle events in ``events.jsonl``."""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from deepdfa_tpu.resilience import inject as jinject
from deepdfa_tpu.resilience import lifecycle as jlifecycle
from deepdfa_tpu_torch import telemetry
from deepdfa_tpu_torch.core.config import FeatureSpec, FlowGNNConfig
from deepdfa_tpu_torch.data.synthetic import synthetic_bigvul
from deepdfa_tpu_torch.models.flowgnn import FlowGNN
from deepdfa_tpu_torch.resilience import inject, lifecycle
from deepdfa_tpu_torch.serve import ServeConfig, ServeEngine
from deepdfa_tpu_torch.serve.batcher import MicroBatcher, ServeRequest
from deepdfa_tpu_torch.serve.http import serve_forever

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMITS = dict(limit_all=20, limit_subkeys=20)
TINY = FlowGNNConfig(feature=FeatureSpec(**LIMITS), hidden_dim=4,
                     n_steps=1, num_output_layers=1)


@pytest.fixture(autouse=True)
def _clean():
    yield
    lifecycle.reset()
    inject.clear()
    telemetry.end_run()


# ---------------------------------------------------------------------------
# The fault plan
# ---------------------------------------------------------------------------


PLANS = [
    {"faults": [{"site": "s", "kind": "nan", "at": 2},
                {"site": "s", "kind": "corrupt", "every": 2, "times": 2}]},
    {"seed": 3, "faults": [{"site": "s", "kind": "kill", "p": 0.3},
                           {"site": "t", "kind": "hang", "p": 0.5,
                            "times": 2},
                           {"site": "s", "kind": "delay", "every": 3,
                            "seconds": 0.0}]},
    {"seed": 11, "faults": [{"site": "serve.batch", "kind": "raise",
                             "every": 4, "exc": "TimeoutError"},
                            {"site": "serve.batch", "kind": "truncate"}]},
]


def _fire_script(mod, doc, n=24):
    plan = mod.FaultPlan.from_doc(json.loads(json.dumps(doc)))
    out = []
    for i in range(n):
        for site in ("s", "t", "serve.batch"):
            try:
                out.append((site, tuple(sp.kind for sp in plan.fire(site))))
            except Exception as e:
                out.append((site, type(e).__name__))
    return out, plan.report()


@pytest.mark.parametrize("doc", PLANS)
def test_fault_plans_fire_as_the_references(doc):
    assert _fire_script(inject, doc) == _fire_script(jinject, doc)


def test_fault_plan_at_every_times_semantics():
    plan = inject.FaultPlan.from_doc({"faults": [
        {"site": "s", "kind": "nan", "at": 2},
        {"site": "s", "kind": "corrupt", "every": 2, "times": 2}]})
    kinds = [tuple(sp.kind for sp in plan.fire("s")) for _ in range(6)]
    assert kinds == [("corrupt",), (), ("nan", "corrupt"), (), (), ()]


def test_fault_plan_raise_name_filter_and_caller_index():
    plan = inject.FaultPlan.from_doc({"faults": [
        {"site": "s", "kind": "raise", "exc": "TimeoutError", "at": 0}]})
    with pytest.raises(TimeoutError):
        plan.fire("s")
    plan = inject.FaultPlan.from_doc({"faults": [
        {"site": "s", "kind": "raise", "exc": "NoSuchError", "at": 0}]})
    with pytest.raises(inject.FaultError):
        plan.fire("s")
    plan = inject.FaultPlan.from_doc({"faults": [
        {"site": "ck", "kind": "corrupt", "name": "last", "at": 1}]})
    assert plan.fire("ck", name="best") == ()
    assert plan.fire("ck", name="last") == ()
    assert [h.kind for h in plan.fire("ck", name="last")] == ["corrupt"]
    plan = inject.FaultPlan.from_doc({"faults": [
        {"site": "e", "kind": "raise", "at": 7}]})
    with pytest.raises(inject.FaultError):
        plan.fire("e", index=7)


def test_armed_restores_unknown_fields_and_the_env_plan(tmp_path,
                                                        monkeypatch):
    plan = inject.FaultPlan.from_doc({"faults": []})
    prev = inject.active()
    with inject.armed(plan):
        assert inject.active() is plan
    assert inject.active() is prev
    with pytest.raises(ValueError, match="unknown field"):
        inject.FaultPlan.from_doc({"faults": [{"site": "s", "kind": "nan",
                                               "bogus": 1}]})
    with pytest.raises(ValueError, match="unknown fault kind"):
        inject.FaultPlan.from_doc({"faults": [{"site": "s", "kind": "x"}]})
    path = tmp_path / "plan.json"
    path.write_text(json.dumps({"faults": [{"site": "x", "kind": "nan"}]}))
    for source in (str(path), path.read_text()):
        monkeypatch.setenv(inject.ENV_VAR, source)
        monkeypatch.setattr(inject, "_PLAN", None)
        monkeypatch.setattr(inject, "_ENV_CHECKED", False)
        armed = inject.active()
        assert armed is not None and [s.site for s in armed.faults] == ["x"]
        assert [s.kind for s in inject.fire("x")] == ["nan"]
    assert inject.ENV_VAR == jinject.ENV_VAR == "DEEPDFA_FAULT_PLAN"


# ---------------------------------------------------------------------------
# The coordinator
# ---------------------------------------------------------------------------


def test_constants_match_the_reference():
    for name in ("EXIT_PREEMPTED", "EXIT_HANG", "GRACE_ENV_VAR",
                 "HANG_ENV_VAR", "DEFAULT_GRACE_S"):
        assert getattr(lifecycle, name) == getattr(jlifecycle, name)
    assert (lifecycle.EXIT_PREEMPTED, lifecycle.EXIT_HANG) == (75, 76)


def test_grace_and_hang_knobs(monkeypatch):
    monkeypatch.setenv(lifecycle.GRACE_ENV_VAR, "4")
    monkeypatch.setenv(lifecycle.HANG_ENV_VAR, "0.5")
    assert lifecycle.grace_budget_s() == 4.0
    assert lifecycle.hang_deadline_s(4.0) == 0.5
    monkeypatch.setenv(lifecycle.GRACE_ENV_VAR, "junk")
    monkeypatch.delenv(lifecycle.HANG_ENV_VAR)
    assert lifecycle.grace_budget_s() == lifecycle.DEFAULT_GRACE_S
    assert lifecycle.hang_deadline_s(4.0) == 2.0


def test_notice_broadcast_and_drain_accounting():
    co = lifecycle.LifecycleCoordinator(grace_s=5.0, hang_s=2.0,
                                        _exit=lambda c: None)
    seen = []
    p = co.register("svc", on_notice=lambda n: seen.append(n.reason),
                    deadline_s=99.0)
    assert p.deadline_s == 5.0
    notice = co.notify("simulated")
    assert seen == ["simulated"]
    assert notice.grace_s == 5.0 and notice.remaining() <= 5.0
    assert co.notify("SIGTERM") is notice
    p.drained(ok=True)
    assert p.drain_ok and p.drain_ms is not None
    assert co._complete.is_set()


def test_inject_site_simulates_preemption():
    plan = inject.FaultPlan.from_doc({"faults": [
        {"site": "lifecycle.preempt", "kind": "kill", "at": 2}]})
    with inject.armed(plan):
        assert lifecycle.poll(0) is None
        assert lifecycle.poll(1) is None
        notice = lifecycle.poll(2)
    assert notice is not None and notice.reason == "simulated"


def test_watchdog_forces_exit_with_stacks_on_a_wedge(tmp_path):
    exits, hangs = [], []
    with telemetry.run_scope(str(tmp_path)):
        co = lifecycle.LifecycleCoordinator(grace_s=10.0, hang_s=0.2,
                                            _exit=exits.append)
        co.register("serve", on_hang=lambda n: hangs.append(n.reason))
        co.notify("simulated")
        deadline = time.monotonic() + 5.0
        while not exits and time.monotonic() < deadline:
            time.sleep(0.02)
    assert exits == [lifecycle.EXIT_HANG] and hangs == ["simulated"]
    assert co.hang_fired
    events = _events(str(tmp_path))
    (hang,) = [e for e in events if e["name"] == "lifecycle.hang"]
    assert hang["attrs"]["why"] == "no_progress"
    assert any("lifecycle-watchdog" in s for s in hang["attrs"]["stacks"])


def test_watchdog_beats_keep_a_progressing_drain_alive():
    exits = []
    co = lifecycle.LifecycleCoordinator(grace_s=10.0, hang_s=0.25,
                                        _exit=exits.append)
    p = co.register("serve")
    co.notify("simulated")
    for _ in range(5):
        time.sleep(0.1)
        p.beat()
    p.drained(ok=True)
    time.sleep(0.4)
    assert exits == [] and not co.hang_fired


def test_the_signal_handler_only_sets_a_flag():
    co = lifecycle.LifecycleCoordinator(grace_s=5.0, _exit=lambda c: None)
    co._handler(signal.SIGTERM, None)
    assert co.notice is None  # nothing but the flag
    notice = co.poll()
    assert notice is not None and notice.reason == "SIGTERM"


def _events(run_dir):
    with open(os.path.join(run_dir, "telemetry", "events.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def test_lifecycle_events_ride_the_run(tmp_path):
    with telemetry.run_scope(str(tmp_path)):
        co = lifecycle.LifecycleCoordinator(grace_s=5.0,
                                            _exit=lambda c: None)
        lifecycle.reset(co)
        p = co.register("serve")
        co.notify("simulated")
        p.drained(ok=True)
    names = [e["name"] for e in _events(str(tmp_path))
             if e["name"].startswith("lifecycle.")]
    assert names == ["lifecycle.notice", "lifecycle.drain",
                     "lifecycle.exit"]
    assert telemetry.REGISTRY.histogram(
        "lifecycle_drain_ms").value["count"] >= 1


# ---------------------------------------------------------------------------
# Serving: the lame duck
# ---------------------------------------------------------------------------


def test_batcher_drain_mode_flushes_partial_buckets_immediately():
    b = MicroBatcher(ServeConfig(batch_slots=4, deadline_ms=10000.0))
    b.admit(ServeRequest(rid=0, key="k", graph={"num_nodes": 1,
                                                "senders": []},
                         lane="gnn", arrival=0.0, deadline_s=10.0))
    assert b.due(now=0.1) is None
    assert b.next_flush_time(now=0.1) == pytest.approx(5.0)
    b.set_drain_mode(True)
    assert b.due(now=0.1) == "gnn"
    assert b.next_flush_time(now=0.1) == pytest.approx(0.1)
    b.take("gnn")
    assert b.last_flush_cause("gnn") == "drain"


def _payload(graphs):
    return [{"id": int(g["id"]),
             "graph": {"num_nodes": int(g["num_nodes"]),
                       "senders": np.asarray(g["senders"]).tolist(),
                       "receivers": np.asarray(g["receivers"]).tolist(),
                       "feats": {k: np.asarray(v).tolist()
                                 for k, v in g["feats"].items()}}}
            for g in graphs]


def _call(url, doc=None, timeout=30.0):
    data = None if doc is None else json.dumps(doc).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read() or b"{}")


def _wait(cond, seconds=30.0):
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < seconds, "timed out"
        time.sleep(0.02)


def test_a_simulated_preemption_drains_the_server(tmp_path, monkeypatch):
    """``DEEPDFA_FAULT_PLAN`` arms a ``lifecycle.preempt`` notice at the
    fourth poll (as a step loop's check would raise it) and slows the
    first flush by 1.5 s: the server lame-ducks with two requests
    admitted in a 4-slot bucket whose deadline flush is 10 s away; while
    their flush runs, a new POST answers 503 with Retry-After and
    /healthz "draining"; then both admitted requests are answered, and
    ``serve_forever`` returns the notice."""
    plan = {"seed": 5, "faults": [
        {"site": "lifecycle.preempt", "kind": "kill", "at": 3},
        {"site": "serve.batch", "kind": "delay", "at": 0, "seconds": 1.5}]}
    monkeypatch.setenv(inject.ENV_VAR, json.dumps(plan))
    monkeypatch.setattr(inject, "_PLAN", None)
    monkeypatch.setattr(inject, "_ENV_CHECKED", False)
    lifecycle.reset(lifecycle.LifecycleCoordinator(grace_s=20.0))
    config = ServeConfig(batch_slots=4, deadline_ms=20000.0)
    engine = ServeEngine(FlowGNN(TINY, device="cpu"), config, device="cpu")
    engine.warmup()
    compiles = engine.stats.compiles
    port_file = str(tmp_path / "port")
    run = str(tmp_path / "run")
    box = {}
    with telemetry.run_scope(run):
        server = threading.Thread(target=lambda: box.update(
            notice=serve_forever(engine, port=0, port_file=port_file)))
        server.start()
        _wait(lambda: os.path.exists(port_file))
        base = f"http://127.0.0.1:{open(port_file).read()}"
        graphs = synthetic_bigvul(4, TINY.feature, seed=3)
        load = threading.Thread(target=lambda: box.update(
            first=_call(f"{base}/score", {"functions": _payload(graphs[:2])},
                        timeout=60.0)))
        t0 = time.monotonic()
        load.start()
        _wait(lambda: engine.pending() == 2)
        poller = threading.Thread(target=lambda: box.update(
            polls=[lifecycle.poll(i) for i in range(4)]))
        poller.start()
        _wait(lambda: engine.lame_duck)
        status, headers, body = _call(f"{base}/score",
                                      {"functions": _payload(graphs[2:3])})
        assert status == 503 and body["error"] == "draining"
        assert int(headers["Retry-After"]) >= 1
        status, _, health = _call(f"{base}/healthz")
        assert status == 503 and health["status"] == "draining"
        load.join(timeout=60)
        poller.join(timeout=60)
        server.join(timeout=60)
        assert not server.is_alive()
    status, _, body = box["first"]
    assert status == 200 and all("prob" in r for r in body["results"])
    assert time.monotonic() - t0 < 8.0  # never waited out the deadline
    assert box["polls"][:3] == [None] * 3
    assert box["notice"] is box["polls"][3]
    assert box["notice"].reason == "simulated"
    assert engine.stats.compiles == compiles
    names = [e["name"] for e in _events(run)]
    for name in ("fault.fired", "lifecycle.notice", "lifecycle.lame_duck",
                 "lifecycle.drain_serve", "lifecycle.drain",
                 "lifecycle.exit"):
        assert name in names, name
    (drain,) = [e for e in _events(run) if e["name"] == "lifecycle.drain"]
    assert drain["attrs"]["participant"] == "serve" and drain["attrs"]["ok"]


def test_cli_serve_drains_on_sigterm_and_exits_75(tmp_path):
    """A real SIGTERM to ``cli serve``: the requests it admitted are
    answered, it exits 75, and ``events.jsonl`` holds the notice and the
    drain. Every wait has its own time limit; the child is killed on any
    failure."""
    port_file = str(tmp_path / "port")
    run = str(tmp_path / "run")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "deepdfa_tpu_torch.cli", "serve", "--device",
         "cpu", "--port", "0", "--port-file", port_file, "--run-dir", run,
         "--set", "model.hidden_dim=8", "--batch-slots", "4",
         "--deadline-ms", "20000"],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        t0 = time.monotonic()
        while not os.path.exists(port_file):
            assert proc.poll() is None, proc.communicate(timeout=10)[1]
            assert time.monotonic() - t0 < 120, "serve did not start"
            time.sleep(0.1)
        base = f"http://127.0.0.1:{open(port_file).read()}"
        graphs = synthetic_bigvul(2, FeatureSpec(), seed=3)
        box = {}
        load = threading.Thread(target=lambda: box.update(out=_call(
            f"{base}/score", {"functions": _payload(graphs)},
            timeout=60.0)))
        load.start()
        _wait(lambda: _call(f"{base}/metrics")[2]["queue_depth"] == 2)
        proc.send_signal(signal.SIGTERM)
        load.join(timeout=60)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=10)
    assert proc.returncode == lifecycle.EXIT_PREEMPTED, err[-3000:]
    last = json.loads(out.strip().splitlines()[-1])
    assert {k: last[k] for k in ("preempted", "reason", "exit_code")} == {
        "preempted": True, "reason": "SIGTERM", "exit_code": 75}
    status, _, body = box["out"]
    assert status == 200 and all("prob" in r for r in body["results"])
    names = [e["name"] for e in _events(run)]
    for name in ("lifecycle.notice", "lifecycle.lame_duck",
                 "lifecycle.drain", "serve.flush", "telemetry.flush"):
        assert name in names, name
    # Every flush of the process is a span; nothing enqueued went
    # unanswered.
    assert names.count("serve.flush") == last["serving"]["batches"] >= 1
    enqueued = {e["attrs"]["rid"] for e in _events(run)
                if e["name"] == "serve.enqueue"}
    answered = {e["attrs"]["rid"] for e in _events(run)
                if e["name"] == "serve.request"}
    assert enqueued and enqueued <= answered
    (notice,) = [e for e in _events(run) if e["name"] == "lifecycle.notice"]
    assert notice["attrs"]["reason"] == "SIGTERM"
    assert notice["attrs"]["participants"] == ["serve"]
    assert os.path.exists(os.path.join(run, "telemetry", "trace.json"))
