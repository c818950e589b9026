"""The MoE layer's readers on a step tracer filled by hand, on a clock
the test moves: each reading against its value worked out here, only
whole batches read, only the newest `len(ctx.records)`, and no reading
where the program has no step tracer."""
from types import SimpleNamespace

import pytest
import torch

from portbench import roofline
from portbench.harness import Bench, model_config
from portbench.tests._tiny import REPO
from repro_torch.obs import tracing as TR

CELL = "mixtral-8x22b.prefill-azure"
METRICS = ("moe_us_per_token.prefill", "expert_ffn_roofline.prefill",
           "expert_rows_useful.prefill")
#: The cell's configuration: d 6,144, f 16,384, 8 experts, top-2.
D, F, E, K = 6144, 16384, 8, 2


class Clock:
    """`perf_counter_ns` of the tracer, moved by hand."""

    def __init__(self):
        self.ns = 0

    def __call__(self):
        return self.ns


@pytest.fixture
def ring(monkeypatch):
    """(fill, the process's step tracer swapped for a fresh one)."""
    clock = Clock()
    monkeypatch.setattr(TR, "perf_counter_ns", clock)
    tr = TR.StepTracer(capacity=64)
    monkeypatch.setattr(TR, "STEP_TRACER", tr)

    def fill(tokens, layers, moe_ns, experts_ns, rows, kept):
        """One batch: a root, then per layer a "moe" span of `moe_ns`
        holding an "experts" span of `experts_ns` with its counts (kept
        as a mask, summed on the device), then the head."""
        with tr.span("prefill_step", tokens=tokens):
            for li in range(layers):
                with tr.span("attention", li):
                    clock.ns += 7_000
                with tr.span("moe", li):
                    clock.ns += moe_ns - experts_ns
                    with tr.span("experts", rows=rows,
                                 kept=torch.arange(rows) < kept):
                        clock.ns += experts_ns
            with tr.span("lm_head"):
                clock.ns += 3_000
    return fill, tr


def read(name, n_records):
    b = Bench(REPO)
    cfg = model_config(b.config(b.cell(CELL)["config"]))
    assert (cfg.d_model, cfg.d_ff, cfg.n_experts,
            cfg.experts_per_token) == (D, F, E, K)
    ctx = SimpleNamespace(cfg=cfg, roofline=roofline,
                          records=[{}] * n_records)
    return b.module("metrics", name).read(ctx)


def test_readings_against_hand_values(ring):
    fill, _ = ring
    # 4,096 tokens: 2 layers of 12 ms MoE, 10 ms experts, 10,240 rows
    # holding 8,000 assignments; 64 tokens: 1 layer of 3 ms, 2 ms, 160
    # rows holding 100
    fill(4096, 2, 12_000_000, 10_000_000, 10_240, 8_000)
    fill(64, 1, 3_000_000, 2_000_000, 160, 100)
    us = read("moe_us_per_token.prefill", 2)
    assert us == pytest.approx((2 * 12_000 + 3_000) / (4096 + 64))
    useful = read("expert_rows_useful.prefill", 2)
    assert useful == pytest.approx(100 * (2 * 8_000 + 100) / (2 * 10_240
                                                                + 160))
    # a layer's bound: its tokens' 2 experts x 3 products x 2*d*f
    # operations at 989 TFLOP/s, or 8 x 3 d x f bf16 weights at
    # 3.35 TB/s: 4,096 tokens are bound by the operations (5.0025 ms),
    # 64 by the weights (1.4424 ms)
    ops_4096 = 4096 * 2 * 3 * 2 * D * F / 989e12
    bytes_once = 8 * 3 * D * F * 2 / 3.35e12
    assert ops_4096 == pytest.approx(5.0025e-3, rel=1e-4)
    assert bytes_once == pytest.approx(1.4424e-3, rel=1e-4)
    assert 64 * 2 * 3 * 2 * D * F / 989e12 < bytes_once
    share = read("expert_ffn_roofline.prefill", 2)
    assert share == pytest.approx(
        100 * (2 * ops_4096 + bytes_once) / (2 * 10e-3 + 2e-3))


def test_only_whole_batches_are_read(ring):
    """A ring of 64 spans: a batch of 3 layers (11 spans), 4 one-span
    roots, then 6 batches of 2 layers (8 spans) each with a one-span
    root after it, 69 spans in all. The newest 64 begin inside the first
    batch, whose root is gone: its MoE spans still held do not count."""
    fill, tr = ring
    fill(100, 3, 50_000_000, 40_000_000, 500, 500)      # partly held
    for _ in range(4):
        with tr.span("mark"):
            pass
    for i in range(6):
        fill(1000, 2, 1_000_000 * (i + 1), 500_000, 2500, 2000)
        with tr.span("mark"):
            pass
    spans = tr.resolve()
    assert list(spans["seq"]) == list(range(5, 69))
    assert (spans["batch"] == 0).sum() == 6
    assert len(tr.batches("prefill_step")) == 6
    us = read("moe_us_per_token.prefill", 100)
    assert us == pytest.approx(2 * 1_000 * sum(range(1, 7)) / 6_000)
    assert read("expert_rows_useful.prefill", 100) == pytest.approx(80.0)


def test_the_newest_records_batches_are_read(ring):
    fill, _ = ring
    fill(100, 1, 9_000_000, 1_000_000, 400, 400)
    fill(100, 1, 1_000_000, 1_000_000, 400, 100)
    fill(100, 1, 3_000_000, 1_000_000, 400, 300)
    assert read("moe_us_per_token.prefill", 2) == pytest.approx(
        (1_000 + 3_000) / 200)
    assert read("expert_rows_useful.prefill", 2) == pytest.approx(50.0)
    # more records than the ring holds batches: the ring's batches
    assert read("moe_us_per_token.prefill", 10) == pytest.approx(
        13_000 / 300)


@pytest.mark.parametrize("name", METRICS)
def test_no_reading_without_batches_or_a_step_tracer(ring, monkeypatch,
                                                     name):
    assert read(name, 3) is None                     # an empty ring
    ring[0](100, 1, 1_000, 1_000, 400, 300)
    assert read(name, 3) is not None
    # a program without the step tracer, as the commit before it
    monkeypatch.delattr(TR, "STEP_TRACER")
    assert read(name, 3) is None
