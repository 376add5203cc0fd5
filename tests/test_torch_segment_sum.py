"""The ordered segment sums' two modes (``deepdfa_tpu_torch/graphs/segment.py``,
``csrc/segment_sum.cu``) on the CPU.

The kernel finds each bucket's rows in sorted keys by a 32-way search of
its warp, as a :class:`SegmentPlan` gives them: the ids themselves where
the caller says that, keyed by the mask, they are non-decreasing
(``indices_are_sorted``), else one stable sort of the int32 keyed ids
with the rows in their order. Here:

- the warp's search, transcribed from the kernel lane by lane, finds the
  lower bounds ``torch.searchsorted`` finds;
- the kernel's walk over those bounds (the emulation below) in both modes
  equals the plain version, ``_segment_sum_ordered``, and the JAX
  package's ``jax.ops.segment_sum`` (XLA's CPU scatter adds in update
  order, at the data's dtype) bit for bit, at f32 and bf16, with and
  without a mask, at widths 1, 3, 128 and the pooling's merged width, at
  in-degrees 0 to 1000; and so does ``segment_sum_rows`` on CPU tensors;
- neither mode's device work reads the host (a CUDA graph captures it);
- every contiguous batch the package builds keys ``node_graph``
  non-decreasing (the sorted mode's contract), slot packing and a batch
  built by hand say it does not, a serving pair keeps its template's word
  and refuses a batch that breaks it, and the plain version refuses
  unsorted ids in sorted mode;
- the segment lane's FlowGNN given one plan a forward gives the logits
  and gradients of the CPU's per-call keying, bit for bit, and builds no
  plan on the CPU; the pooling's one call for both sums equals two
  calls.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepdfa_tpu_torch.core.config import FeatureSpec, FlowGNNConfig
from deepdfa_tpu_torch.data.synthetic import synthetic_bigvul
from deepdfa_tpu_torch.graphs import segment
from deepdfa_tpu_torch.graphs.batch import GraphBatch, batch_graphs
from deepdfa_tpu_torch.models import flowgnn as pt_flowgnn
from deepdfa_tpu_torch.models.flowgnn import FlowGNN, GlobalAttentionPool
from deepdfa_tpu_torch.serve import ServeConfig
from deepdfa_tpu_torch.serve.engine import _Staged, bucket_batch
from test_torch_serve_graphs import _HostReads

SUBKEYS = ["api", "datatype", "literal", "operator"]
DEGREES = [(0, 1, 5), (64, 0, 300), (1,) * 40, (2, 3, 1000, 7)]
# The pooling's merged call: the weighted rows (out_dim 256 at the
# published width) and the softmax denominators.
WIDTHS = [1, 3, 128, "merged"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the first multi-threaded ``torch.exp`` of a
    process can be off in one thread's chunk (MKL's first use,
    ``scripts/torch_first_exp_race.py``); these tests compare floats
    exactly."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The kernel, transcribed
# ---------------------------------------------------------------------------


def _warp_bounds(key_at, n_rows, s):
    """``bucket_rows`` of ``csrc/segment_sum.cu``: the lower bounds of
    ``s`` and ``s + 1`` in the sorted keys, both searched at once, each
    round a probe a lane and a ballot of the probes under the target.
    Returns (lo, hi, rounds)."""
    lo, hi = [0, 0], [n_rows, n_rows]
    rounds = 0
    while lo[0] < hi[0] or lo[1] < hi[1]:
        rounds += 1
        counts = []
        for i, target in enumerate((s, s + 1)):
            st = (hi[i] - lo[i] + 31) >> 5
            ballot = [lo[i] + lane * st < hi[i]
                      and key_at(lo[i] + lane * st) < target
                      for lane in range(32)]
            # Keys are sorted: the probes under the target are a prefix.
            c = sum(ballot)
            assert ballot == [True] * c + [False] * (32 - c)
            counts.append((c, st))
        for i, (c, st) in enumerate(counts):
            if c == 0:
                hi[i] = lo[i]
            else:
                hi[i] = min(lo[i] + c * st, hi[i])
                lo[i] += (c - 1) * st + 1
    return lo[0], lo[1], rounds


def _emulate(parts, n_seg, keys, mask=None, order=None):
    """The kernel's arithmetic: bucket ``s``'s rows from ``_warp_bounds``
    over the keys (keyed by ``mask``: a masked row's key is ``n_seg``),
    row ``order[k]`` (or ``k``) added in turn at the data's dtype."""
    keys = keys.tolist()
    live = None if mask is None else mask.tolist()
    key_at = (lambda p: keys[p]) if live is None else (
        lambda p: keys[p] if live[p] else n_seg)
    outs = [torch.zeros((n_seg,) + tuple(x.shape[1:]), dtype=x.dtype)
            for x in parts]
    for s in range(n_seg):
        lo, hi, _ = _warp_bounds(key_at, len(keys), s)
        rows = [int(order[k]) if order is not None else k
                for k in range(lo, hi)]
        for x, out in zip(parts, outs):
            acc = torch.zeros(x.shape[1:], dtype=x.dtype)
            for r in rows:
                acc = acc + x[r]
            out[s] = acc
    return outs


@pytest.mark.parametrize("n_rows", [0, 1, 31, 32, 33, 1000, 4096])
def test_the_warp_search_finds_the_lower_bounds(n_rows):
    rng = np.random.default_rng(n_rows)
    n_seg = 1 + n_rows // 3
    keys = np.sort(rng.integers(0, n_seg + 1, n_rows))
    # Long runs: one bucket holds most rows.
    if n_rows > 40:
        keys[5:n_rows - 5] = keys[5]
    want = np.searchsorted(keys, np.arange(-1, n_seg + 2), side="left")
    rounds = []
    for j, s in enumerate(range(-1, n_seg + 1)):
        lo, hi, r = _warp_bounds(lambda p: int(keys[p]), n_rows, s)
        assert (lo, hi) == (want[j], want[j + 1]), s
        rounds.append(r)
    # A range of n keys takes ceil(log32 n) rounds, + 1 where it ends.
    assert max(rounds) <= (0 if n_rows == 0 else
                           int(np.ceil(np.log(n_rows) / np.log(32))) + 1)


# ---------------------------------------------------------------------------
# Both modes against the plain version and jax.ops.segment_sum
# ---------------------------------------------------------------------------


def _case(degrees, width, dtype, masked, seed, shuffle):
    """Rows of ``len(degrees)`` buckets (bucket ``s`` has ``degrees[s]``
    rows), in bucket order or shuffled, with masked padding: after the
    rows in bucket order (the pooling's layout), anywhere when shuffled.
    Masked rows are zero and point at bucket 0, as a batch's padding.
    Returns (parts, ids, mask)."""
    rng = np.random.default_rng(seed)
    ids = np.repeat(np.arange(len(degrees)), degrees)
    n_pad = 7 if masked else 0
    live = np.ones(len(ids) + n_pad, bool)
    if masked:
        live[len(ids):] = False
        ids = np.concatenate([ids, np.zeros(n_pad, ids.dtype)])
    if shuffle:
        perm = rng.permutation(len(ids))
        ids, live = ids[perm], live[perm]
        if masked:
            live &= rng.random(len(ids)) > 0.2
    widths = (256, 1) if width == "merged" else (width,)
    parts = []
    for w in widths:
        shape = (len(ids),) if w == 1 else (len(ids), w)
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                             ).to(dtype)
        m = torch.from_numpy(live)
        parts.append(torch.where(m if w == 1 else m[:, None], x, 0.0))
    mask = torch.from_numpy(live) if masked else None
    return tuple(parts), torch.from_numpy(ids.astype(np.int32)), mask


def _xla(x, ids, mask, n_seg, sorted_ids):
    """``jax.ops.segment_sum`` at the data's dtype on the same rows (masked
    rows zero), read back as a torch tensor of that dtype."""
    jx = jnp.asarray(x.float().numpy()).astype(
        jnp.bfloat16 if x.dtype == torch.bfloat16 else jnp.float32)
    keyed = segment._bucket_ids(ids, n_seg, mask).numpy()
    out = jax.ops.segment_sum(jx, jnp.asarray(keyed), num_segments=n_seg,
                              indices_are_sorted=sorted_ids)
    return torch.from_numpy(np.array(out.astype(jnp.float32))).to(x.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("degrees", DEGREES)
def test_both_modes_equal_the_plain_version_and_xla(dtype, masked, width,
                                                    degrees):
    n_seg = len(degrees)
    seed = sum(degrees) + len(str(width))
    # Sorted mode: rows in bucket order, the padding after them.
    parts, ids, mask = _case(degrees, width, dtype, masked, seed, False)
    keyed = segment._bucket_ids(ids, n_seg, mask)
    want = [segment._segment_sum_ordered(x, keyed, n_seg) for x in parts]
    got = _emulate(parts, n_seg, ids, mask)
    rows = segment.segment_sum_rows(parts, segment.segment_sum_plan(
        ids, n_seg, mask, indices_are_sorted=True))
    for g, r, w, x in zip(got, rows, want, parts):
        assert torch.equal(g, w) and torch.equal(r, w)
        assert torch.equal(w, _xla(x, ids, mask, n_seg, True))
    # Plan mode: the same buckets' rows shuffled, masked rows anywhere.
    parts, ids, mask = _case(degrees, width, dtype, masked, seed, True)
    plan = segment.segment_sum_plan(ids, n_seg, mask)
    keyed = segment._bucket_ids(ids, n_seg, mask)
    want = [segment._segment_sum_ordered(x, keyed, n_seg) for x in parts]
    assert plan.mask is None and torch.equal(plan.keyed(), keyed)
    got = _emulate(parts, n_seg, plan.keys, order=plan.order)
    rows = segment.segment_sum_rows(parts, plan)
    for g, r, w, x in zip(got, rows, want, parts):
        assert torch.equal(g, w) and torch.equal(r, w)
        assert torch.equal(w, _xla(x, ids, mask, n_seg, False))


@pytest.mark.parametrize("masked", [False, True])
def test_neither_mode_reads_the_host(masked):
    """What the kernel reads (a plan's keys, mask and order), as
    ``segment_sum_plan`` makes it on the ids' device: sorted mode the ids
    and the mask as they are (no op at all), plan mode the keying and one
    sort. Neither reads the host."""
    parts, ids, mask = _case((3, 0, 9, 4), 128, torch.float32, masked, 5,
                             False)
    with _HostReads() as mode:
        plan = segment.segment_sum_plan(ids, 4, mask,
                                        indices_are_sorted=True)
    assert mode.seen == [] and plan.order is None
    assert plan.keys is ids and plan.ids is ids and plan.mask is mask
    with _HostReads() as mode:
        plan = segment.segment_sum_plan(ids, 4, mask)
    assert mode.seen == [] and plan.mask is None
    keyed = segment._bucket_ids(ids, 4, mask)
    assert torch.equal(plan.ids, keyed)
    assert torch.equal(plan.keys, keyed[plan.order])


def test_sorted_mode_refuses_unsorted_ids():
    sorted_plan = lambda ids, mask=None: segment.segment_sum_plan(
        ids, 3, mask, indices_are_sorted=True)
    ids = torch.tensor([0, 1, 1, 0, 2], dtype=torch.int32)
    x = torch.ones(5, 3)
    with pytest.raises(ValueError, match="decrease"):
        segment.segment_sum_rows(x, sorted_plan(ids))
    # A masked row in the middle is keyed past every bucket: unsorted too.
    ids = torch.tensor([0, 1, 1, 2, 2], dtype=torch.int32)
    mask = torch.tensor([True, True, False, True, True])
    with pytest.raises(ValueError, match="decrease"):
        segment.segment_sum_rows(x, sorted_plan(ids, mask))
    # Masked rows after the last bucket's keep it sorted.
    mask = torch.tensor([True, True, True, True, False])
    out = segment.segment_sum_rows(x, sorted_plan(ids, mask))
    assert out[:, 0].tolist() == [1.0, 2.0, 1.0]
    # An index plan takes the same ids in any order.
    out = segment.segment_sum_rows(x, segment.segment_sum_plan(
        ids.flip(0), 3, mask.flip(0)))
    assert out[:, 0].tolist() == [1.0, 2.0, 1.0]


# ---------------------------------------------------------------------------
# The sorted mode's contract: every contiguous batch keys node_graph in order
# ---------------------------------------------------------------------------


def _keyed_sorted(gb) -> bool:
    keyed = segment._bucket_ids(gb.node_graph, gb.n_graphs, gb.node_mask)
    return bool(torch.all(keyed[1:] >= keyed[:-1]))


@pytest.mark.parametrize("impl", ["python", "native"])
@pytest.mark.parametrize("n_real", [0, 1, 5, 16])
def test_contiguous_batches_key_node_graph_in_order(impl, n_real):
    graphs = synthetic_bigvul(16, FeatureSpec(**dict(limit_all=20,
                                                    limit_subkeys=20)),
                              seed=n_real)[:n_real]
    gb = batch_graphs(graphs, 16, 2048, 8192, SUBKEYS, impl=impl)
    assert gb.node_graph_sorted and _keyed_sorted(gb)
    assert gb.to("cpu").node_graph_sorted


@pytest.mark.parametrize("band", [False, True])
def test_serving_buckets_key_node_graph_in_order(band):
    """Every slot bucket the engine warms, full and partial (empty slots
    after the last graph)."""
    cfg = FlowGNNConfig()
    config = ServeConfig()
    graphs = synthetic_bigvul(40, cfg.feature, seed=3)
    subkeys = ["api", "datatype", "literal", "operator"]
    for slots in (1, 2, 4, 8, 16):
        for n in sorted({1, max(slots // 2, 1), slots}):
            gb = bucket_batch(config, graphs[:n], slots, subkeys, band=band)
            assert gb.node_graph_sorted and _keyed_sorted(gb), (slots, n)


def test_text_batches_key_node_graph_in_order():
    """``text_graph_batches`` puts graph k in text row k's slot, rows
    ascending, the rows without a graph empty."""
    from deepdfa_tpu_torch.train.text_loop import _slotted_graph_batch

    graphs = synthetic_bigvul(6, FeatureSpec(**dict(limit_all=20,
                                                   limit_subkeys=20)),
                              seed=4)
    slots = [(0, graphs[0]), (2, graphs[1]), (3, graphs[2]), (7, graphs[3])]
    gb = _slotted_graph_batch(slots, 8, 512, 2048, SUBKEYS)
    assert gb.node_graph_sorted and _keyed_sorted(gb)


def test_slot_packing_says_node_graph_is_not_in_order():
    graphs = synthetic_bigvul(3, FeatureSpec(**dict(limit_all=20,
                                                   limit_subkeys=20)),
                              seed=5)
    gb = batch_graphs(graphs, 4, 256, 1024, SUBKEYS, slot_nodes=64,
                      impl="python")
    assert not gb.node_graph_sorted and not _keyed_sorted(gb)


def test_a_batch_built_by_hand_is_not_taken_as_sorted():
    """A GraphBatch that no packer built makes no claim: the pooling
    builds its index plan."""
    gb = batch_graphs(synthetic_bigvul(2, FeatureSpec(**dict(
        limit_all=20, limit_subkeys=20)), seed=6), 4, 256, 1024, SUBKEYS,
        impl="python")
    fields = {f.name: getattr(gb, f.name)
              for f in dataclasses.fields(gb) if f.name != "node_graph_sorted"}
    assert not GraphBatch(**fields).node_graph_sorted


def test_a_serving_pair_keeps_its_templates_word():
    """``_Staged`` builds the captured batch with the template's flag,
    and refuses to stage a batch that does not keep it (its replays would
    search an unsorted node_graph as sorted)."""
    config = ServeConfig()
    graphs = synthetic_bigvul(4, FlowGNNConfig().feature, seed=8)
    template = bucket_batch(config, graphs[:2], 4, SUBKEYS)
    staged = _Staged(template, None, torch.device("cpu"))
    assert staged.batch.node_graph_sorted
    live = bucket_batch(config, graphs[2:], 4, SUBKEYS)
    staged.stage(live, None)
    assert torch.equal(staged.batch.node_graph, live.node_graph)
    with pytest.raises(ValueError, match="not sorted"):
        staged.stage(dataclasses.replace(live, node_graph_sorted=False),
                     None)
    unsorted = dataclasses.replace(template, node_graph_sorted=False)
    staged = _Staged(unsorted, None, torch.device("cpu"))
    assert not staged.batch.node_graph_sorted
    staged.stage(live, None)


# ---------------------------------------------------------------------------
# The callers: one plan a forward, one launch a pooling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_plan_a_forward_equals_a_plan_per_call(dtype, monkeypatch):
    """The segment lane's FlowGNN builds the receivers' plan once a
    forward on the card and hands it to each step. On the CPU it builds
    none (each step's sum keys the ids itself). A forward whose steps are
    all handed one plan, built at the first (as on the card), gives the
    logits and every parameter's gradient of the per-call keying, bit for
    bit."""
    cfg = FlowGNNConfig(feature=FeatureSpec(limit_all=20, limit_subkeys=20),
                        hidden_dim=8, num_output_layers=2,
                        message_impl="segment", dtype=dtype)
    graphs = synthetic_bigvul(6, cfg.feature, seed=7)
    gb = batch_graphs(graphs, 8, 512, 2048, SUBKEYS, impl="python")
    plans = []
    real_plan = segment.segment_sum_plan

    def counted(*args, **kw):
        plans.append(args[0])
        return real_plan(*args, **kw)

    def run():
        model = FlowGNN(cfg, device="cpu", seed=2)
        logits = model(gb)
        logits.sum().backward()
        return logits.detach(), {n: p.grad.clone()
                                 for n, p in model.named_parameters()
                                 if p.grad is not None}

    monkeypatch.setattr(segment, "segment_sum_plan", counted)
    monkeypatch.setattr(pt_flowgnn, "segment_sum_plan", counted)
    per_call = run()
    assert plans == []
    real_step = pt_flowgnn.GatedGraphStep.forward
    given = []

    def one_plan(self, h, batch, packed=None, plan=None):
        assert plan is None
        if not given:
            given.append(counted(batch.receivers, batch.max_nodes,
                                 batch.edge_mask))
        return real_step(self, h, batch, packed, given[0])

    monkeypatch.setattr(pt_flowgnn.GatedGraphStep, "forward", one_plan)
    once = run()
    assert len(plans) == 1 and plans[0] is gb.receivers
    assert torch.equal(once[0], per_call[0])
    assert once[1].keys() == per_call[1].keys() and once[1]
    for name, g in once[1].items():
        assert torch.equal(g, per_call[1][name]), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("slot_pack", [False, True])
def test_the_pooling_sums_both_in_one_call(dtype, slot_pack, monkeypatch):
    """``GlobalAttentionPool``'s ``rows`` form takes its weighted sums and
    denominators in one ``segment_sum_rows`` call (sorted mode for a
    contiguous batch, a plan for a slot-packed one): the bits of the two
    separate calls it made before, and within rounding of the segment
    form."""
    cfg = FlowGNNConfig(feature=FeatureSpec(limit_all=20, limit_subkeys=20))
    graphs = synthetic_bigvul(5, cfg.feature, seed=9)
    gb = batch_graphs(graphs, 8, 1024, 4096, SUBKEYS,
                      slot_nodes=64 if slot_pack else None, impl="python")
    rng = np.random.default_rng(3)
    feat = torch.from_numpy(rng.standard_normal(
        (gb.max_nodes, 64)).astype(np.float32)).to(dtype)
    pool = GlobalAttentionPool(64, torch.Generator().manual_seed(1),
                               impl="rows", dtype=dtype)
    calls = []
    real_rows = segment.segment_sum_rows

    def spy(data, plan):
        calls.append(plan.order is None)
        return real_rows(data, plan)

    monkeypatch.setattr(pt_flowgnn, "segment_sum_rows", spy)
    with torch.inference_mode():
        got = pool(feat, gb.node_graph, gb.node_mask, gb.n_graphs,
                   gb.node_graph_sorted)
        assert calls == [not slot_pack]
        # The two calls of the form before: denominators, then sums.
        gate = pt_flowgnn._dense(pool.gate, feat, dtype)[:, 0]
        onehot = segment.segment_onehot(gb.node_graph, gb.n_graphs,
                                        mask=gb.node_mask)
        gate = torch.where(gb.node_mask, gate.float(), -torch.inf)
        shift = torch.where(onehot != 0, gate[None, :],
                            -torch.inf).amax(dim=1)
        shift = torch.where(torch.isneginf(shift), 0.0, shift)
        e = torch.where(gb.node_mask, torch.exp(gate - shift @ onehot), 0.0)
        weighted = feat * e[:, None].to(dtype)
        plan = segment.segment_sum_plan(gb.node_graph, gb.n_graphs,
                                        gb.node_mask)
        denom = segment.segment_sum_rows(e, plan)
        sums = segment.segment_sum_rows(weighted.float(), plan)
        denom = torch.where(denom > 0, denom, 1.0)
        want = (sums / denom[:, None]).to(dtype)
        assert torch.equal(got, want)
        pool.impl = "segment"
        seg = pool(feat, gb.node_graph, gb.node_mask, gb.n_graphs)
    tol = 1e-6 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), seg.float(), rtol=tol, atol=tol)
