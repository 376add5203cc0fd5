"""The port's HTTP transport (``serve/http.py``) and ``cli serve`` on the
CPU, over real sockets: 200 with inline per-function results (the gnn
and combined lanes, a degraded answer), cached replays, 400, 404, 413,
429 with an integer Retry-After, 500 for a failed flush, ``/healthz`` and
``/metrics`` with the reference's keys, and a clean Ctrl-C shutdown of
``cli serve`` (the lifecycle's drain: exit 75, as the reference's)."""

import dataclasses
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

torch = pytest.importorskip("torch")

from deepdfa_tpu_torch import telemetry
from deepdfa_tpu_torch.core.config import FeatureSpec, FlowGNNConfig
from deepdfa_tpu_torch.data.synthetic import synthetic_bigvul
from deepdfa_tpu_torch.data.text import HashingCodeTokenizer
from deepdfa_tpu_torch.models.flowgnn import FlowGNN
from deepdfa_tpu_torch.models.linevul import LineVul
from deepdfa_tpu_torch.models.transformer import EncoderConfig
from deepdfa_tpu_torch.serve import ServeConfig, ServeEngine
from deepdfa_tpu_torch.serve.http import ServeHTTPServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMITS = dict(limit_all=20, limit_subkeys=20)
GNN = dict(feature=FeatureSpec(**LIMITS), hidden_dim=4, n_steps=1,
           num_output_layers=1)
BLOCK = 32
# A lone surrogate cannot be encoded to UTF-8: the tokenizer raises on
# such code, and the request degrades to the gnn lane.
UNENCODABLE = "int f(char *p) { return '\ud800'; }"
# The /healthz keys the reference adds from parts not ported yet.
NOT_PORTED = {"scan_pool"}
# The port's own /metrics keys, fleet-wide and in each replica's section:
# programs built after warmup, and the bytes of the replicas' CUDA graph
# pools.
PORT_ONLY = {"compiles_after_warmup", "graph_pool_bytes"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the first ``torch.exp`` of a process that
    splits across threads (MKL's ``vmsExp``, more than 2048 elements)
    can come back with a relative error near 1e-4 in one thread's chunk
    (``scripts/torch_first_exp_race.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _payload(graphs, code=None):
    out = []
    for g in graphs:
        fn = {"id": int(g["id"]), "graph": {
            "num_nodes": int(g["num_nodes"]),
            "senders": np.asarray(g["senders"]).tolist(),
            "receivers": np.asarray(g["receivers"]).tolist(),
            "feats": {k: np.asarray(v).tolist()
                      for k, v in g["feats"].items()}}}
        if code is not None:
            fn["code"] = code
        out.append(fn)
    return out


def _post(base, doc, path="/score", raw=None):
    req = urllib.request.Request(
        f"{base}{path}", data=raw if raw is not None else
        json.dumps(doc).encode(), headers={"Content-Type":
                                           "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, dict(resp.headers), json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def _get(base, path):
    try:
        with urllib.request.urlopen(f"{base}{path}", timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _engine(slots=2, queue=None, deadline_ms=40.0):
    enc = dataclasses.replace(EncoderConfig.tiny(),
                              max_position_embeddings=70)
    gnn = FlowGNN(FlowGNNConfig(**GNN), device="cpu", seed=1)
    comb = LineVul(enc, FlowGNNConfig(encoder_mode=True, **GNN),
                   device="cpu", seed=2)
    cfg = ServeConfig(batch_slots=slots, block_size=BLOCK,
                      deadline_ms=deadline_ms,
                      queue_capacity=queue or 256)
    eng = ServeEngine(gnn, cfg, device="cpu", combined_model=comb,
                      tokenizer=HashingCodeTokenizer(enc.vocab_size))
    eng.warmup()
    return eng


class _Server:
    def __init__(self, engine, pump=True):
        self.server = ServeHTTPServer(("127.0.0.1", 0), engine)
        if pump:
            self.server.start_pump()
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.base = f"http://127.0.0.1:{self.server.server_address[1]}"

    def close(self):
        if not self.server.pump_thread.is_alive():
            self.server.start_pump()
        self.server.shutdown()
        self.server.server_close()


def test_score_answers_and_status_codes():
    eng = _engine()
    srv = _Server(eng)
    try:
        g = synthetic_bigvul(4, FeatureSpec(**LIMITS), seed=5)
        mixed = (_payload(g[:1]) + _payload(g[1:2], "int f(int a) "
                                            "{ return a; }")
                 + _payload(g[2:3], UNENCODABLE))
        status, _, out = _post(srv.base, {"functions": mixed})
        assert status == 200
        res = out["results"]
        assert [r["model"] for r in res] == ["gnn", "combined", "gnn"]
        assert [r["degraded"] for r in res] == [False, False, True]
        assert all(0.0 <= r["prob"] <= 1.0 and not r["cached"] for r in res)
        status, _, again = _post(srv.base, {"functions": mixed})
        assert status == 200 and all(r["cached"]
                                     for r in again["results"])
        assert [r["prob"] for r in again["results"]] == [r["prob"]
                                                         for r in res]
        # Malformed envelopes: 400; an entry inline.
        for doc, raw in (({"functions": []}, None), (None, b"{nope"),
                         ({"functions": _payload(g[:1]),
                           "deadline_ms": -1}, None)):
            status, _, body = _post(srv.base, doc, raw=raw)
            assert status == 400 and body["error"] == "bad_request"
        status, _, body = _post(srv.base, {"functions": [
            {"graph": {"num_nodes": 2}}, None] + _payload(g[3:4])})
        assert status == 200
        assert [r.get("error") for r in body["results"]] == [
            "bad_request", "bad_request", None]
        # Unknown paths: 404.
        assert _post(srv.base, {"functions": mixed}, path="/scan")[0] == 404
        assert _get(srv.base, "/nope") == (404, {"error": "not_found"})
        # Every function oversized: 413, errors inline; mixed: 200.
        big = synthetic_bigvul(2, FeatureSpec(**LIMITS), seed=1,
                               min_nodes=70, max_nodes=80)
        status, _, body = _post(srv.base, {"functions": _payload(big)})
        assert status == 413
        assert [r["error"] for r in body["results"]] == ["oversized"] * 2
        status, _, body = _post(srv.base, {"functions": _payload(big[:1])
                                           + _payload(g[:1])})
        assert status == 200 and body["results"][1]["cached"]
        status, health = _get(srv.base, "/healthz")
        # The process's drop count (other tests may have dropped events).
        assert status == 200 and health == {
            "status": "ok", "warm_buckets": 4,
            "telemetry_drops": telemetry.drop_count()}
        status, metrics = _get(srv.base, "/metrics")
        assert metrics["degraded"] == 2 and metrics["oversized"] == 3
        assert metrics["compiles"] == 4 and metrics["n_replicas"] == 1
    finally:
        srv.close()


def test_429_with_retry_after_when_every_function_is_shed():
    eng = _engine(slots=2, queue=2, deadline_ms=3000.0)
    srv = _Server(eng, pump=False)
    try:
        g = synthetic_bigvul(3, FeatureSpec(**LIMITS), seed=7)
        eng.submit(g[0])
        eng.submit(g[1], code="int f();")  # two lanes, neither full
        status, headers, body = _post(srv.base,
                                      {"functions": _payload(g[2:])})
        assert status == 429 and body["error"] == "rejected"
        assert body["retry_after_s"] == pytest.approx(1.5)
        assert headers["Retry-After"] == "2"
        assert eng.snapshot()["rejected"] == 1
    finally:
        srv.close()  # starts the pump, which drains the two requests
    assert eng.pending() == 0


def test_500_when_every_function_died_in_a_failed_flush():
    eng = _engine()
    real = eng._infer
    calls = []

    def flaky(batch):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("device lost")
        return real(batch)

    eng._infer = flaky
    srv = _Server(eng)
    try:
        g = synthetic_bigvul(4, FeatureSpec(**LIMITS), seed=9)
        status, _, body = _post(srv.base, {"functions": _payload(g[:2])})
        assert status == 500
        assert all(r["error"] == "internal" and "device lost" in r["detail"]
                   for r in body["results"])
        status, _, body = _post(srv.base, {"functions": _payload(g[2:])})
        assert status == 200 and all("prob" in r for r in body["results"])
        assert _get(srv.base, "/metrics")[1]["failures"] == 2
    finally:
        srv.close()


def test_healthz_and_metrics_keys_match_the_reference():
    jax = pytest.importorskip("jax")
    from deepdfa_tpu.core.config import FeatureSpec as JFeatureSpec
    from deepdfa_tpu.core.config import FlowGNNConfig as JFlowGNNConfig
    from deepdfa_tpu.models.flowgnn import FlowGNN as JFlowGNN
    from deepdfa_tpu.serve import ServeConfig as JServeConfig
    from deepdfa_tpu.serve import ServeEngine as JServeEngine
    from deepdfa_tpu.serve.engine import random_gnn_params
    from deepdfa_tpu.serve.http import ServeHTTPServer as JServeHTTPServer

    jcfg = JFlowGNNConfig(feature=JFeatureSpec(**LIMITS), hidden_dim=4,
                          n_steps=1, num_output_layers=1)
    jmodel = JFlowGNN(jcfg)
    config = JServeConfig(batch_slots=2, deadline_ms=40.0)
    jeng = JServeEngine(jmodel, random_gnn_params(jmodel, config),
                        config=config)
    jeng.warmup()
    peng = ServeEngine(FlowGNN(FlowGNNConfig(**GNN), device="cpu"),
                       ServeConfig(batch_slots=2, deadline_ms=40.0),
                       device="cpu")
    peng.warmup()
    g = synthetic_bigvul(3, FeatureSpec(**LIMITS), seed=5)
    bodies = {}
    for name, server in (("jax", JServeHTTPServer(("127.0.0.1", 0), jeng)),
                         ("port", ServeHTTPServer(("127.0.0.1", 0), peng))):
        server.start_pump()
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            _post(base, {"functions": _payload(g)})
            _post(base, {"functions": _payload(g)})
            bodies[name] = (_get(base, "/healthz")[1],
                            _get(base, "/metrics")[1])
        finally:
            server.shutdown()
    (jh, jm), (ph, pm) = bodies["jax"], bodies["port"]
    assert set(ph) == set(jh) - NOT_PORTED
    assert set(pm) == set(jm) | {"kernel_launches"} | PORT_ONLY
    assert not any(pm["kernel_launches"].values())  # the CPU: none
    assert set(pm["replicas"]["r0"]) == set(jm["replicas"]["r0"]) | PORT_ONLY
    assert pm["compiles_after_warmup"] == 0 and pm["graph_pool_bytes"] == 0
    assert set(pm["padding_waste"]["gnn:b2"]) == set(
        jm["padding_waste"]["gnn:b2"])
    for key in ("submitted", "completed", "cache_hits", "batches",
                "compiles", "n_replicas"):
        assert pm[key] == jm[key], key


def _wait_for(path, proc, seconds=120.0):
    t0 = time.monotonic()
    while not os.path.exists(path):
        if proc.poll() is not None or time.monotonic() - t0 > seconds:
            out, err = proc.communicate(timeout=10)
            raise AssertionError(f"serve did not start: {err[-3000:]}")
        time.sleep(0.1)
    with open(path) as f:
        return int(f.read())


def test_cli_serve_over_http_and_a_clean_shutdown(tmp_path):
    from deepdfa_tpu_torch import cli

    run = str(tmp_path / "combined")
    assert cli.main(["fit-text", "--tiny", "--device", "cpu", "--dataset",
                     "synthetic:24", "--graphs", "synthetic", "--epochs",
                     "1", "--batch-size", "4", "--block-size", str(BLOCK),
                     "--no-test", "--checkpoint-dir", run]) == 0
    port_file = str(tmp_path / "port")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "deepdfa_tpu_torch.cli", "serve", "--device",
         "cpu", "--port", "0", "--port-file", port_file,
         "--combined-checkpoint-dir", run, "--set", "model.hidden_dim=8",
         "--batch-slots", "4", "--queue-capacity", "4",
         "--deadline-ms", "60000"],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        base = f"http://127.0.0.1:{_wait_for(port_file, proc)}"
        g = synthetic_bigvul(7, FeatureSpec(), seed=3)
        code = "int f(char *p) { return p[1]; }"
        first = _payload(g[:2]) + _payload(g[2:4], code)
        # Two requests on each lane, neither lane full and their deadline
        # flush 3 s away: the queue holds 4 of 4, so the next POST is shed.
        box = {}
        worker = threading.Thread(target=lambda: box.update(out=_post(
            base, {"functions": first, "deadline_ms": 6000})))
        worker.start()
        t0 = time.monotonic()
        while _get(base, "/metrics")[1]["queue_depth"] < 4:
            assert time.monotonic() - t0 < 30
            time.sleep(0.02)
        status, headers, body = _post(base, {"functions": _payload(g[4:5])})
        assert status == 429 and headers["Retry-After"] == "30"
        assert body["retry_after_s"] == pytest.approx(30.0)
        worker.join(timeout=60)
        status, _, body = box["out"]
        assert status == 200
        assert [r["model"] for r in body["results"]] == [
            "gnn", "gnn", "combined", "combined"]
        # Replays come from the cache; unencodable code degrades.
        status, _, body = _post(base, {"functions": first,
                                       "deadline_ms": 20})
        assert status == 200 and all(r["cached"] for r in body["results"])
        status, _, body = _post(base, {"functions": _payload(
            g[5:6], UNENCODABLE), "deadline_ms": 20})
        assert status == 200 and body["results"][0]["degraded"]
        assert body["results"][0]["model"] == "gnn"
        assert _post(base, {"functions": "all"})[0] == 400
        assert _get(base, "/nope")[0] == 404
        big = synthetic_bigvul(1, FeatureSpec(), seed=1, min_nodes=70,
                               max_nodes=80)
        assert _post(base, {"functions": _payload(big)})[0] == 413
        status, health = _get(base, "/healthz")
        assert status == 200 and health["slo"]["ok"]
        assert health == {"status": "ok", "warm_buckets": 6,
                          "telemetry_drops": 0, "slo": health["slo"]}
        metrics = _get(base, "/metrics")[1]
        assert metrics["compiles"] == 6 and metrics["degraded"] == 1
        assert metrics["cache_hits"] == 4 and metrics["rejected"] == 1
    finally:
        proc.send_signal(signal.SIGINT)
        out, err = proc.communicate(timeout=60)
    # Ctrl-C is a preemption notice: drained, then the reference's 75.
    assert proc.returncode == 75, err[-3000:]
    last = json.loads(out.strip().splitlines()[-1])
    assert {k: last[k] for k in ("preempted", "reason", "exit_code")} == {
        "preempted": True, "reason": "SIGINT", "exit_code": 75}
    assert last["serving"]["degraded"] == 1
    assert "KeyboardInterrupt" not in err
