"""The port's four kernels against their plain torch versions on the
card. Every test here needs an NVIDIA card (marker
`cuda`) and skips without one; on the card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_kernels_card.py

The shapes include the edges of the bf16 tensor-core kernels: ragged
lengths (300, 200), Lk > Lq, windows, GQA rep 2, head dims that are not
a multiple of 16 (40) or are padded (16), P and N that the wrapper pads
to multiples of 8 (P 40, N 24 and 4).

The forest kernel runs one row, ragged batches, stacks over 48 KB of
tables (T 100 and 256 at D 6), depths 1, 8 and 12 (two tree tiles), K 1,
4 and 10, and batches that take 16 and 8 lanes a row; the template kernel T 48 to 1,008 with constant, all-zero and
tied rows.

The streamed serving loop (`submit_to`, `depart_to`, `cap_to`, `flush`
with the power-emergency plane) runs on the card at a small width: its
decisions, alarms and throttled-seconds must equal the same stream on the
CPU, the forest kernel must carry every micro-batch, and a second run must
be bit-equal to the first (departures sum in a fixed order). The same holds
with the ballooning rung and the adaptive controller on as well, where the
rung must fire and the controller ratchet and back off.

Bars: forest leaf indices exact, sums within 1e-5 per tree of the plain
version and bit-equal to its emulated summation order; template scores
within rtol 5e-3 / atol 5e-4; flash atol 2e-5 in float32 and 2e-2 in
bf16, SSD atol 2e-4 in float32 (tests/test_kernels.py). An SSD output in bf16 can round to the
neighbouring bf16 value, so it gets the bf16 bar plus one bf16 ulp (at
most 2^-7 relative).
"""
import numpy as np
import pytest
import torch

from _torch_parity import cuda  # noqa: F401
from repro_torch.device import KERNEL_LAUNCHES, reset_launches
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.kernels.forest import ops as forest_ops
from repro_torch.kernels.forest import ref as forest_ref
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ref as ssd_ref
from repro_torch.kernels.template import ops as template_ops
from repro_torch.kernels.template import ref as template_ref

FLASH_ATOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _normal(rng, *shape):
    return torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lq,lk,window,d,causal", [
    (100, 200, 50, 32, True), (512, 512, None, 80, True),
    (64, 192, None, 128, True), (64, 96, None, 16, False),
    (256, 256, 64, 80, True), (300, 300, None, 40, True),
    (300, 700, 128, 80, True), (300, 700, None, 128, False),
    (300, 300, 100, 16, True)])
def test_flash_kernel_matches_plain_version(cuda, dtype, lq, lk, window, d,
                                            causal):
    rng = np.random.default_rng(lq + lk + d)
    q = _normal(rng, 2, 4, lq, d).to(cuda, dtype)
    k = _normal(rng, 2, 2, lk, d).to(cuda, dtype)
    v = _normal(rng, 2, 2, lk, d).to(cuda, dtype)
    reset_launches()
    got = flash_ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert KERNEL_LAUNCHES["flash_attention"] == 1
    want = flash_ref.attention_ref(q, k.repeat_interleave(2, 1),
                                   v.repeat_interleave(2, 1), causal=causal,
                                   window=window)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(),
                               atol=FLASH_ATOL[dtype], rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l,h,p,n", [(100, 3, 16, 8), (512, 4, 64, 64),
                                     (200, 2, 64, 128), (5, 2, 8, 4),
                                     (200, 3, 16, 128), (300, 2, 40, 24)])
def test_ssd_kernel_matches_plain_version(cuda, dtype, l, h, p, n):
    rng = np.random.default_rng(l + p + n)
    x = _normal(rng, 2, l, h, p).to(cuda, dtype)
    dt = torch.from_numpy(rng.uniform(0.001, 0.2, (2, l, h))
                          .astype(np.float32)).to(cuda)
    a = -torch.from_numpy(rng.uniform(0.3, 2.0, h).astype(np.float32)) \
        .to(cuda)
    bm = _normal(rng, 2, l, n).to(cuda, dtype)
    cm = _normal(rng, 2, l, n).to(cuda, dtype)
    d = _normal(rng, h).to(cuda)
    reset_launches()
    got = ssd_ops.ssd(x, dt, a, bm, cm, d)
    torch.cuda.synchronize()
    assert KERNEL_LAUNCHES["ssd"] == 1
    want = ssd_ref.ssd_chunked(x, dt, a, bm, cm, d,
                               chunk=min(128, max(l, 8)))
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=2e-4, rtol=0)
        exact, _ = ssd_ref.ssd_ref(x, dt, a, bm, cm, d)
        torch.testing.assert_close(got, exact, atol=2e-4, rtol=0)
    else:
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                   rtol=2 ** -7)


@pytest.mark.cuda
@pytest.mark.parametrize("b,nf,t,d,k", [
    (1, 4, 48, 6, 2), (256, 4, 48, 6, 2), (300, 4, 48, 6, 2),
    (256, 4, 100, 6, 2), (256, 4, 256, 6, 2), (256, 4, 48, 1, 2),
    (256, 4, 48, 8, 2), (256, 4, 48, 6, 1), (256, 4, 48, 6, 4),
    (256, 4, 48, 6, 10), (130, 1, 400, 12, 3), (65, 2, 33, 3, 2),
    (600, 4, 48, 6, 2), (4096, 4, 48, 6, 2), (4096, 4, 100, 6, 2)])
def test_forest_kernel_matches_plain_version(cuda, b, nf, t, d, k):
    rng = np.random.default_rng(b + t + d + k)
    x = _normal(rng, b, 18).to(cuda)
    fi = torch.from_numpy(rng.integers(0, 18, (nf, t, d))
                          .astype(np.int32)).to(cuda)
    thr = _normal(rng, nf, t, d).to(cuda)
    leaf = _normal(rng, nf, t, 1 << d, k).to(cuda)
    reset_launches()
    got = forest_ops.forest_sums(x, fi, thr, leaf)
    torch.cuda.synchronize()
    assert KERNEL_LAUNCHES["forest"] == 1
    plan = forest_ops.launch_plan(b, 18, nf, t, d, k)
    torch.testing.assert_close(
        got, forest_ref.forest_sums_ref(x, fi, thr, leaf), atol=1e-5 * t,
        rtol=0)
    assert torch.equal(got, forest_ref.forest_sums_lanes(
        x, fi, thr, leaf, tile=plan["tile"], lanes=plan["lanes"]))
    # leaf indices: one-tree forests whose leaf l holds l
    probe = torch.arange(1 << d, dtype=torch.float32, device=cuda) \
        .expand(nf * t, 1, 1 << d)[..., None].contiguous()
    idx = forest_ops.forest_sums(x, fi.reshape(nf * t, 1, d).contiguous(),
                                 thr.reshape(nf * t, 1, d).contiguous(),
                                 probe)[..., 0].round().long()
    assert torch.equal(idx.reshape(b, nf, t),
                       forest_ref.leaf_index_ref(x, fi, thr))


def _template_rows(rng, t):
    rows = rng.uniform(0, 100, (64, t))
    tied = rng.choice([0.0, 50.0, 100.0], (4, t))
    return np.concatenate([rows, tied, np.full((1, t), 25.0),
                           np.zeros((1, t))]).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [48, 96, 144, 240, 480, 528, 1008])
def test_template_kernel_matches_plain_version(cuda, t):
    x = torch.from_numpy(_template_rows(np.random.default_rng(t), t)) \
        .to(cuda)
    reset_launches()
    got = template_ops.criticality_scores(x)
    torch.cuda.synchronize()
    assert KERNEL_LAUNCHES["template"] == 1
    want = template_ref.criticality_scores_ref(x)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=5e-3, atol=5e-4)
    assert float(got[-2:].abs().max()) == 0.0     # constant, zero rows


def _stream_world():
    from repro_torch.core import criticality
    from repro_torch.core import features as F
    from repro_torch.core.predictor import train_service
    from repro_torch.sim.telemetry import generate_population
    pop = generate_population(500, seed=0)
    hist, arrivals = F.split_history_arrivals(pop)
    labels = criticality.classify(hist.series, device="cpu").numpy()
    aggs = F.subscription_aggregates(hist, labels)
    svc = train_service(F.build_features(hist, aggs),
                        labels.astype(np.int64),
                        F.p95_bucket([v.p95_util for v in hist.vms]),
                        n_trees=12)
    return svc, hist, labels, arrivals


def _streamed_run(world, device, hosts):
    """Arrival chunks dealt over `hosts`, departures of the admitted rows
    two chunks back, and a cap sweep of every chassis (one sampled twice)
    every other chunk, stamped between arrival ticks."""
    from repro_torch.serve import (EmergencyConfig, PlaneBundle,
                                   ServeConfig, ServePipeline)
    from repro_torch.sim.telemetry import arrival_batch, arrival_stamps
    svc, hist, labels, arrivals = world
    pipe = ServePipeline.from_history(
        svc, hist, labels, n_servers=48, cores_per_server=40,
        blades_per_chassis=12, device=device, config=ServeConfig(
            batch_size=32, n_ingest_hosts=hosts, planes=PlaneBundle(
                emergency=EmergencyConfig.from_model(1560.0))))
    n = 32 * (len(arrivals.vms) // 32)
    stamps = arrival_stamps(n)
    cores = np.array([v.cores for v in arrivals.vms], np.float32)
    power = np.random.default_rng(3).uniform(1450.0, 1750.0,
                                             (n // 32, 5))
    res = []
    for k in range(n // 32):
        idx = np.arange(32 * k, 32 * (k + 1))
        for h in range(hosts):
            rows = idx[idx % hosts == h]
            res += pipe.submit_to(h, arrival_batch(arrivals, rows),
                                  t=stamps[rows])
        t_end = stamps[idx[-1]]
        if k >= 2:
            r = res[k - 2]
            rows = np.flatnonzero(r.server >= 0)[::2]
            res += pipe.depart_to(
                k % hosts, r.server[rows], cores[32 * (k - 2) + rows],
                r.p95_eff[rows], r.workload_type[rows] == 1,
                t=t_end + 0.25 + 1e-6 * np.arange(len(rows)))
        if k % 2:
            res += pipe.cap_to((k + 1) % hosts, [0, 1, 2, 3, 1], power[k],
                               t=t_end + 0.5 + np.arange(1, 6) * 1e-7)
    tail = pipe.flush()
    res += [] if tail is None else [tail]
    return pipe, res


@pytest.mark.cuda
def test_streamed_serve_with_emergencies_matches_cpu(cuda):
    world = _stream_world()
    reset_launches()
    card, res = _streamed_run(world, cuda, hosts=1)
    torch.cuda.synchronize()
    assert KERNEL_LAUNCHES["forest"] == len(res)
    cpu, res_cpu = _streamed_run(world, "cpu", hosts=1)
    card4, res4 = _streamed_run(world, cuda, hosts=4)
    again, res_again = _streamed_run(world, cuda, hosts=1)
    assert card.alarms > 0
    for other, other_res in ((cpu, res_cpu), (card4, res4),
                             (again, res_again)):
        assert other.alarms == card.alarms
        np.testing.assert_array_equal(other.throttled_by_level(),
                                      card.throttled_by_level())
        for a, b in zip(res, other_res, strict=True):
            np.testing.assert_array_equal(a.server, b.server)
            np.testing.assert_array_equal(a.conservative, b.conservative)
    for f in ("free_cores", "gamma_uf", "gamma_nuf", "res_peak"):
        for other in (again, card4):
            assert torch.equal(getattr(card.state, f),
                               getattr(other.state, f)), f
        torch.testing.assert_close(getattr(card.state, f).cpu(),
                                   getattr(cpu.state, f), rtol=1e-6,
                                   atol=0)


#: Utilization of each sweep of the two-plane stream: calm and rising (the
#: adaptive controller ratchets), hot (it backs off, and the hot chassis'
#: cuts reach past the NUF floor, so the ballooning rung fires), calm.
PLANE_UTILS = [0.40, 0.41, 0.42, 0.43, 0.44, 0.45, 0.95, 0.95,
               0.40, 0.40, 0.40, 0.40, 0.40, 0.40]


def _planes_run(world, device, hosts, samples=None):
    """The streamed loop with the emergency plane, its ballooning rung and
    the adaptive controller: arrival chunks dealt over `hosts`, departures
    (with their GB) of the admitted rows two chunks back, and after every
    chunk two sweeps of every chassis. Sweep powers are `samples` when
    given, else `sampled_power` at the next PLANE_UTILS value on the live
    aggregates. Returns the pipeline, the results, the samples and the
    most GB ballooned out after any sweep."""
    from repro_torch.serve import (AdaptiveConfig, BallooningConfig,
                                   EmergencyConfig, PlaneBundle,
                                   ServeConfig, ServePipeline, emergency)
    from repro_torch.sim.telemetry import arrival_batch, arrival_stamps
    svc, hist, labels, arrivals = world
    ecfg = EmergencyConfig.from_model(1560.0)
    pipe = ServePipeline.from_history(
        svc, hist, labels, n_servers=48, cores_per_server=40,
        blades_per_chassis=12, device=device, config=ServeConfig(
            batch_size=32, n_ingest_hosts=hosts, planes=PlaneBundle(
                emergency=ecfg, ballooning=BallooningConfig(),
                adaptive=AdaptiveConfig(window=8, min_history=3,
                                        hot_util=0.63, step_up=0.15,
                                        step_down=0.5, ratio_max=3.0))))
    n = 16 * len(PLANE_UTILS)
    stamps = arrival_stamps(n)
    cores = np.array([v.cores for v in arrivals.vms], np.float32)
    mem = np.array([v.memory_gb for v in arrivals.vms], np.float32)
    res, swept, ballooned = [], [], []
    for k in range(n // 32):
        idx = np.arange(32 * k, 32 * (k + 1))
        for h in range(hosts):
            rows = idx[idx % hosts == h]
            res += pipe.submit_to(h, arrival_batch(arrivals, rows),
                                  t=stamps[rows])
        t_end = stamps[idx[-1]]
        if k >= 2:
            r = res[k - 2]
            rows = np.flatnonzero(r.server >= 0)[::2]
            res += pipe.depart_to(
                k % hosts, r.server[rows], cores[32 * (k - 2) + rows],
                r.p95_eff[rows], r.workload_type[rows] == 1,
                mem_gb=mem[32 * (k - 2) + rows],
                t=t_end + 0.25 + 1e-6 * np.arange(len(rows)))
        for j in range(2):
            if samples is None:
                st = pipe.state
                rho = emergency.chassis_rho_levels(
                    st.gamma_nuf, st.gamma_uf, st.chassis_servers)
                power = emergency.sampled_power(
                    ecfg, rho, PLANE_UTILS[len(swept)],
                    torch.zeros(rho.shape, dtype=torch.int32, device=device),
                    torch.zeros(4, dtype=torch.bool, device=device)) \
                    .cpu().numpy()
            else:
                power = samples[len(swept)]
            swept.append(power)
            res += pipe.cap_to((k + j + 1) % hosts, np.arange(4), power,
                               t=t_end + 0.5 + 0.1 * j
                               + np.arange(1, 5) * 1e-7)
            ballooned.append(pipe.ballooned_gb())
    tail = pipe.flush()
    res += [] if tail is None else [tail]
    return pipe, res, swept, max(ballooned)


@pytest.mark.cuda
def test_streamed_serve_with_both_planes_matches_cpu(cuda):
    """Ballooning and the adaptive controller on the card: decisions,
    alarms, throttled-seconds and the controller state equal the same
    stream (same sweep powers) on the CPU and at 4 hosts; a second card
    run is bit-equal; the rung fires and the ratio both ratchets and
    backs off."""
    world = _stream_world()
    reset_launches()
    card, res, samples, peak_gb = _planes_run(world, cuda, hosts=1)
    torch.cuda.synchronize()
    assert KERNEL_LAUNCHES["forest"] == len(res)
    runs = [_planes_run(world, "cpu", 1, samples),
            _planes_run(world, cuda, 4, samples),
            _planes_run(world, cuda, 1)]
    st = card.adaptive_state
    assert int(st.ratchets) > 0 and int(st.backoffs) > 0
    assert card.alarms > 0 and peak_gb > 0
    for other, other_res, _, _ in runs:
        assert other.alarms == card.alarms
        np.testing.assert_array_equal(other.throttled_by_level(),
                                      card.throttled_by_level())
        for a, b in zip(res, other_res, strict=True):
            np.testing.assert_array_equal(a.server, b.server)
            np.testing.assert_array_equal(a.conservative, b.conservative)
        for f in ("count", "head", "ratio", "ratchets", "backoffs"):
            assert torch.equal(getattr(st, f).cpu(),
                               getattr(other.adaptive_state, f).cpu()), f
    # the CPU's aggregates may differ from the card's in the last float32
    # bit (as in the emergency-only stream above), and the windows and
    # balloons read them; two card runs are bit-equal
    cpu = runs[0][0]
    torch.testing.assert_close(cpu.adaptive_state.util, st.util.cpu(),
                               rtol=1e-6, atol=0)
    torch.testing.assert_close(cpu.balloon_state.ballooned_gb,
                               card.balloon_state.ballooned_gb.cpu(),
                               rtol=1e-6, atol=1e-6)
    assert runs[0][3] == pytest.approx(peak_gb, rel=1e-6)
    again = runs[2]
    assert all(np.array_equal(a, b) for a, b in zip(again[2], samples))
    assert again[3] == peak_gb
    for pipe in (runs[1][0], again[0]):
        for f in ("free_cores", "gamma_uf", "gamma_nuf", "res_peak",
                  "mem_nuf"):
            assert torch.equal(getattr(card.state, f),
                               getattr(pipe.state, f)), f
        assert torch.equal(card.balloon_state.ballooned_gb,
                           pipe.balloon_state.ballooned_gb)
        assert torch.equal(st.util, pipe.adaptive_state.util)
