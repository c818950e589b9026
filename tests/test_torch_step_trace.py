"""The step tracer (`repro_torch.obs.tracing.StepTracer`) inside the
prefill step: the span tree a batch records, its counts, the ring, the
shared clock with ``torch.profiler``, and that nothing records where no
prefill step runs. The `cuda` tests need the card and skip without one:
on the card, ``python -m pytest -m cuda tests/test_torch_step_trace.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import cuda  # noqa: F401
from repro_torch.configs import get_config
from repro_torch.launch.steps import (make_eval_step, make_prefill_step,
                                      make_serve_step, make_train_step)
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.obs import tracing as TR

#: 2 x 1,040 tokens make 4,160 assignments: past the dropless limit, so
#: the capacity drops some.
B, L = 2, 1040
LAYER_SPANS = ["attention", "attn_core", "moe", "route", "dispatch",
               "experts", "combine"]


def tiny_moe(n_layers=2):
    return dataclasses.replace(
        get_config("mixtral-8x22b"), n_layers=n_layers, d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512,
        sliding_window=4096, n_experts=4)


@pytest.fixture(scope="module")
def model():
    cfg = tiny_moe()
    params = T.init_params(cfg, 0, torch.float32, "cpu")
    gen = torch.Generator().manual_seed(1)
    batches = [torch.randint(0, cfg.vocab_size, (B, L), generator=gen)
               for _ in range(2)]
    return cfg, params, batches


@pytest.fixture(scope="module")
def traced(model):
    """Two batches through the traced step, the routings each dispatch
    made, and the logits."""
    cfg, params, batches = model
    tr = TR.StepTracer(capacity=256)
    routed = []

    def route(*a, **kw):
        r = real_route(*a, **kw)
        routed.append(r)
        return r

    real_route = M.route
    M.route = route
    try:
        step = make_prefill_step(cfg, tracer=tr)
        logits = [step(params, {"tokens": t}) for t in batches]
    finally:
        M.route = real_route
    return tr, routed, logits


def test_one_root_a_batch_with_the_layer_tree(model, traced):
    cfg = model[0]
    tr = traced[0]
    batches = tr.batches("prefill_step")
    assert len(batches) == 2
    want = ["prefill_step"] + LAYER_SPANS * cfg.n_layers + ["lm_head"]
    for spans in batches:
        root = spans[0]
        assert list(spans["name"]) == want
        assert (spans["batch"] == root["seq"]).all()
        assert root["parent"] == -1 and root["tokens"] == B * L
        by_seq = {int(s["seq"]): s for s in spans}
        for s in spans[1:]:
            parent = by_seq[int(s["parent"])]
            if s["name"] in ("attention", "moe", "lm_head"):
                assert parent["name"] == "prefill_step"
            elif s["name"] == "attn_core":
                assert parent["name"] == "attention"
            else:
                assert parent["name"] == "moe"
        layers = spans["layer"][1:-1].reshape(cfg.n_layers, -1)
        assert (layers == np.arange(cfg.n_layers)[:, None]).all()
        assert spans["layer"][0] == spans["layer"][-1] == -1
    assert batches[1][0]["seq"] == batches[0][-1]["seq"] + 1


def test_children_lie_inside_their_parents(traced):
    for spans in traced[0].batches("prefill_step"):
        by_seq = {int(s["seq"]): s for s in spans}
        for s in spans[1:]:
            p = by_seq[int(s["parent"])]
            assert p["t0_ns"] <= s["t0_ns"]
            assert s["t0_ns"] + s["host_ns"] <= p["t0_ns"] + p["host_ns"]
        # on the host the device time is the host time
        assert (spans["device_ns"] == spans["host_ns"]).all()


def test_experts_count_their_rows_and_kept_assignments(model, traced):
    cfg = model[0]
    tr, routed = traced[:2]
    experts = np.concatenate([b[b["name"] == "experts"]
                              for b in tr.batches("prefill_step")])
    assert len(experts) == len(routed) == 2 * cfg.n_layers
    for s, r in zip(experts, routed):
        # the prefill's products compute the kept rows alone, not E*C
        assert s["kept"] == int(r.keep.sum())
        assert s["rows"] == s["kept"] < cfg.n_experts * r.capacity
    # the capacity dropped assignments: kept is not merely T*k
    assert (experts["kept"] < B * L * cfg.experts_per_token).any()
    others = np.concatenate(tr.batches("prefill_step"))
    others = others[others["name"] != "experts"]
    assert (others["rows"] == -1).all() and (others["kept"] == -1).all()


def test_the_ring_wraps_whole(model):
    """A ring of 64 spans over batches of 16, with a one-span root
    between them, holds three whole batches and part of a fourth."""
    cfg, params, batches = model
    tr = TR.StepTracer(capacity=40)
    assert tr.capacity == 64
    step = make_prefill_step(cfg, tracer=tr)
    for i in range(5):
        step(params, {"tokens": batches[0][:, :64]})
        with tr.span("mark"):
            pass
    assert len(tr) == 64
    spans = tr.resolve()
    assert list(spans["seq"]) == list(range(5 * 17 - 64, 5 * 17))
    whole = tr.batches("prefill_step")
    assert [int(b[0]["seq"]) for b in whole] == [34, 51, 68]
    assert all(len(b) == 16 for b in whole)
    assert [int(b[0]["seq"]) for b in tr.batches("prefill_step", 2)] \
        == [51, 68]
    assert [len(b) for b in tr.batches("mark")] == [1, 1, 1, 1]


def test_no_tracer_records_nothing_and_logits_match(model, traced):
    cfg, params, batches = model
    before = TR.STEP_TRACER._next_seq
    plain = make_prefill_step(cfg, tracer=None)
    for t, got in zip(batches, traced[2]):
        assert torch.equal(plain(params, {"tokens": t}), got)
    assert TR.STEP_TRACER._next_seq == before and TR._ACTIVE is None


def test_no_span_in_decode_training_or_eval():
    cfg = tiny_moe(n_layers=1)
    params = T.init_params(cfg, 0, torch.float32, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 8))
    tr = TR.STEP_TRACER
    before = tr._next_seq
    cache = T.init_cache(cfg, 2, 8, device="cpu")
    decode = make_serve_step(cfg)
    for i in range(2):
        _, cache = decode(params, cache, {"tokens": tokens[:, i:i + 1],
                                          "cache_index": i})
    batch = {"tokens": tokens, "labels": tokens}
    make_eval_step(cfg)(params, batch)
    train = make_train_step(cfg, microbatches=1)
    from repro_torch.optim import get_optimizer
    opt = get_optimizer(cfg.optimizer)
    train(params, opt.init(params), batch)
    assert tr._next_seq == before and TR._ACTIVE is None


def test_spans_share_the_profilers_clock(model):
    """Under a CPU profiler each span is a record_function event of its
    name, stamped within 1 ms of the span's `time.time_ns` start."""
    from torch.profiler import ProfilerActivity, profile
    cfg, params, batches = model
    tr = TR.StepTracer()
    step = make_prefill_step(cfg, tracer=tr)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(params, {"tokens": batches[0][:, :128]})
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            events.setdefault(e.name(), []).append(e.start_ns())
    spans = tr.resolve()
    assert len(spans) == 16
    for s in spans:
        starts = events[str(s["name"])]
        assert min(abs(t - int(s["t0_ns"])) for t in starts) < 1_000_000


def test_unknown_counts_are_refused():
    with pytest.raises(ValueError, match="unknown counts"):
        TR.StepTracer().span("x", tokenz=3)


@pytest.mark.cuda
def test_device_times_on_the_card(cuda):
    cfg = tiny_moe()
    params = T.init_params(cfg, 0, torch.bfloat16, cuda)
    tokens = torch.randint(0, cfg.vocab_size, (B, L), device=cuda)
    tr = TR.StepTracer(capacity=256)
    got = make_prefill_step(cfg, impl="cuda", tracer=tr)(
        params, {"tokens": tokens})
    want = make_prefill_step(cfg, impl="cuda", tracer=None)(
        params, {"tokens": tokens})
    assert torch.equal(got, want)
    (spans,) = tr.batches("prefill_step")
    assert len(spans) == 2 + len(LAYER_SPANS) * cfg.n_layers
    assert np.isfinite(spans["device_ns"]).all()
    assert (spans["device_ns"] > 0).all()
    by_seq = {int(s["seq"]): s for s in spans}
    for s in spans[1:]:
        assert s["device_ns"] <= by_seq[int(s["parent"])]["device_ns"]
    experts = spans[spans["name"] == "experts"]
    assert (experts["kept"] > 0).all()
    assert (experts["kept"] <= experts["rows"]).all()


@pytest.mark.cuda
def test_nothing_records_under_graph_capture(cuda):
    cfg = tiny_moe(n_layers=1)
    params = T.init_params(cfg, 0, torch.bfloat16, cuda)
    tokens = torch.randint(0, cfg.vocab_size, (1, 64), device=cuda)
    tr = TR.StepTracer()
    step = make_prefill_step(cfg, tracer=tr)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step(params, {"tokens": tokens})            # warm on the stream
    torch.cuda.current_stream().wait_stream(side)
    before = tr._next_seq
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step(params, {"tokens": tokens})
        with tr.span("direct", device=cuda):
            pass
    assert tr._next_seq == before and TR._ACTIVE is None
    graph.replay()
    torch.cuda.synchronize()
    assert out.isfinite().all()
