"""The port's per-host ingest (`repro_torch.serve.ingest`) and telemetry
stream helpers against the JAX package's, on the CPU: the same pushes give
the same merged streams (stamps, hosts, kinds, every payload column and
its dtype), and the same seed gives the same stamped streams.

The reference's own ingest tests fail collection on the installed jax, so
its module is imported here through `_torch_parity.reference_serve`.
"""
import numpy as np
import pytest

from repro.sim import telemetry as RT

from _torch_parity import reference_serve
from repro_torch.serve import ingest as PI
from repro_torch.sim import telemetry as PT


@pytest.fixture(scope="module")
def ri():
    return reference_serve("ingest")


def _assert_soa_equal(got, want, what):
    assert type(got).__name__ == type(want).__name__, what
    for f in want.__dataclass_fields__:
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype, f"{what}.{f} dtype"
        np.testing.assert_array_equal(a, b, err_msg=f"{what}.{f}")


def _assert_events_equal(got, want):
    assert len(got) == len(want)
    for f in ("t", "host", "kind"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in ("arrivals", "departures", "caps"):
        _assert_soa_equal(getattr(got, f), getattr(want, f), f)
    assert list(got.runs()) == list(want.runs())


def _oracle_order(stamps_by_host):
    t = np.concatenate([np.asarray(s, float) for s in stamps_by_host])
    host = np.concatenate([np.full(len(s), h, np.int32)
                           for h, s in enumerate(stamps_by_host)])
    seq = np.concatenate([np.arange(len(s)) for s in stamps_by_host])
    order = np.lexsort((seq, host, t))
    return host[order], seq[order]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kway_merge_matches_reference_and_lexsort(ri, seed):
    rng = np.random.default_rng(seed)
    # integer stamps force cross-host ties, so (host, seq) breaks them
    stamps = [np.sort(rng.integers(0, 30, rng.integers(0, 50)))
              .astype(float) for _ in range(5)]
    got_h, got_i = PI.kway_merge(stamps)
    want_h, want_i = ri.kway_merge(stamps)
    np.testing.assert_array_equal(got_h, want_h)
    np.testing.assert_array_equal(got_i, want_i)
    assert got_h.dtype == want_h.dtype and got_i.dtype == want_i.dtype
    np.testing.assert_array_equal((got_h, got_i), _oracle_order(stamps))


@pytest.mark.parametrize("stamps", [[], [np.array([1.0, 2.0])],
                                    [np.empty(0), np.array([0.5])]])
def test_kway_merge_empty_and_single(ri, stamps):
    for a, b in zip(PI.kway_merge(stamps), ri.kway_merge(stamps)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("rate", [None, 40.0])
def test_stream_helpers_match_reference(rate):
    pop_p = PT.generate_population(90, seed=3)
    pop_r = RT.generate_population(90, seed=3)
    np.testing.assert_array_equal(PT.arrival_stamps(90, rate, seed=5),
                                  RT.arrival_stamps(90, rate, seed=5))
    assert len(PT.arrival_stamps(0)) == 0
    for (tp, bp), (tr, br) in zip(
            PT.stream_arrivals(pop_p, 16, rate, seed=2),
            RT.stream_arrivals(pop_r, 16, rate, seed=2), strict=True):
        assert tp == tr
        _assert_soa_equal(bp, br, "stream_arrivals")
    sp = PT.split_streams(pop_p, 4, 8, rate, seed=7)
    sr = RT.split_streams(pop_r, 4, 8, rate, seed=7)
    for hp, hr in zip(sp, sr, strict=True):
        for (tp, bp), (tr, br) in zip(hp, hr, strict=True):
            np.testing.assert_array_equal(tp, tr)
            _assert_soa_equal(bp, br, "split_streams")
    mp, mr = PT.merge_streams(sp), RT.merge_streams(sr)
    np.testing.assert_array_equal(mp[0], mr[0])
    np.testing.assert_array_equal(mp[1], mr[1])
    _assert_soa_equal(mp[2], mr[2], "merge_streams")
    empty_p, empty_r = PT.merge_streams([]), RT.merge_streams([])
    _assert_soa_equal(empty_p[2], empty_r[2], "merge_streams([])")


def _dep(mod, n, lo=0):
    return mod.DepartureBatch(np.arange(lo, lo + n, dtype=np.int32),
                              np.full(n, 2.0, np.float32),
                              np.full(n, 0.5, np.float32),
                              np.arange(n) % 2 == 0)


def _caps(mod, chassis, power):
    return mod.CapBatch(np.asarray(chassis, np.int32),
                        np.asarray(power, np.float32))


def _scripted(ing, tel):
    """Watermark gating, ties across hosts, heartbeats, empty pushes,
    close and drain over three hosts and all three event kinds; returns
    every released window and the pending counts seen on the way."""
    pop = tel.generate_population(24, seed=1)
    mux = ing.IngestMux(3)
    seen, pending = [], []

    def poll():
        seen.append(mux.poll())
        pending.append((mux.n_pending, mux.watermark))
    mux.submit_to(0, tel.arrival_batch(pop, np.arange(8)),
                  t=np.arange(1.0, 9.0))
    poll()                                       # hosts 1, 2 never pushed
    mux.depart_to(1, _dep(ing, 3), t=np.array([0.5, 2.0, 4.0]))
    mux.cap_to(1, _caps(ing, [0, 2], [1500.0, 1700.0]),
               t=np.array([4.5, 4.5]))           # ties within a host
    poll()                                       # host 2 still at -inf
    mux.submit_to(2, tel.arrival_batch(pop, np.arange(8, 12)),
                  t=np.array([2.0, 3.0, 4.0, 4.5]))   # ties across hosts
    poll()
    mux.heartbeat(1, 6.0)
    mux.cap_to(2, _caps(ing, [], []), t=7.0)     # empty push: heartbeat
    poll()
    mux.close(2)
    mux.submit_to(1, tel.arrival_batch(pop, np.arange(12, 16)))  # unit clock
    mux.depart_to(0, _dep(ing, 2, lo=5), t=np.array([9.5, 9.5]))
    poll()
    mux.cap_to(0, _caps(ing, [1, 1, 3], [1400.0, 1800.0, 1600.0]),
               t=np.array([10.0, 10.0, 11.0]))
    seen.append(mux.drain())
    pending.append((mux.n_pending, mux.watermark))
    seen.append(mux.poll())                       # nothing left
    return seen, pending


def test_mux_scripted_stream_matches_reference(ri):
    got, got_pending = _scripted(PI, PT)
    want, want_pending = _scripted(ri, RT)
    assert got_pending == want_pending
    for g, w in zip(got, want, strict=True):
        _assert_events_equal(g, w)
    kinds = np.concatenate([e.kind for e in got])
    assert set(kinds.tolist()) == {PI.ARRIVAL, PI.DEPARTURE, PI.CAPPING}
    assert sum(len(e) for e in got) == 16 + 3 + 2 + 2 + 3


@pytest.mark.parametrize("seed", [0, 1])
def test_mux_random_stream_matches_reference(ri, seed):
    """Random pushes of all three kinds over four hosts, with polls,
    heartbeats and a drain in between: every released window equal."""
    def run(ing, tel):
        rng = np.random.default_rng(seed)
        pop = tel.generate_population(200, seed=seed)
        mux = ing.IngestMux(4)
        clock = np.zeros(4)
        out, row = [], 0
        for _ in range(40):
            h = int(rng.integers(0, 4))
            n = int(rng.integers(1, 9))
            t = clock[h] + np.cumsum(rng.integers(0, 3, n)) \
                + rng.integers(1, 3)
            kind = rng.integers(0, 4)
            if kind == 0:
                idx = np.arange(row, row + n) % 200
                mux.submit_to(h, tel.arrival_batch(pop, idx), t=t)
                row += n
            elif kind == 1:
                mux.depart_to(h, _dep(ing, n, lo=int(rng.integers(0, 40))),
                              t=t)
            elif kind == 2:
                mux.cap_to(h, _caps(ing, rng.integers(0, 5, n),
                                    rng.uniform(1000, 2000, n)), t=t)
            else:
                t = t[-1:]
                mux.heartbeat(h, float(t[0]))
            clock[h] = t[-1]
            out.append(mux.poll())
        out.append(mux.drain())
        return out
    for g, w in zip(run(PI, PT), run(ri, RT), strict=True):
        _assert_events_equal(g, w)


def test_mux_agrees_with_merge_streams_oracle(ri):
    pop = PT.generate_population(120, seed=3)
    streams = PT.split_streams(pop, 4, 16, arrival_rate_per_s=50.0, seed=7)
    mux = PI.IngestMux(4)
    for h, chunks in enumerate(streams):
        for stamps, batch in chunks:
            mux.submit_to(h, batch, t=stamps)
    ev = mux.drain()
    t, host, merged = PT.merge_streams(streams)
    np.testing.assert_array_equal(ev.t, t)
    np.testing.assert_array_equal(ev.host, host)
    _assert_soa_equal(ev.arrivals, merged, "arrivals")


def test_host_queue_rejects_what_the_reference_rejects(ri):
    for ing, tel in ((PI, PT), (ri, RT)):
        pop = tel.generate_population(8, seed=0)
        q = ing.HostQueue(0)
        q.push_arrivals(tel.arrival_batch(pop, np.arange(4)),
                        t=np.array([1.0, 2.0, 2.0, 3.0]))   # ties ok
        for bad in (np.array([3.0, 4.0, 5.0, 6.0]),      # not after last
                    np.array([9.0, 8.0, 10.0, 11.0]),    # decreasing
                    np.array([9.0, 10.0])):              # wrong length
            with pytest.raises(ValueError):
                q.push_arrivals(tel.arrival_batch(pop, np.arange(4, 8)),
                                t=bad)
        with pytest.raises(ValueError):
            q.heartbeat(3.0)
        q.close()
        assert q.watermark == np.inf
        with pytest.raises(ValueError):
            q.push_caps(_caps(ing, [0], [1.0]), t=9.0)
    with pytest.raises(ValueError):
        PI.IngestMux(0)


def test_slice_and_empty_batches_match_reference(ri):
    for name in ("empty_arrivals", "empty_departures", "empty_caps"):
        _assert_soa_equal(getattr(PI, name)(), getattr(ri, name)(), name)
    d = PI.DepartureBatch(np.arange(4, dtype=np.int32),
                          np.ones(4, np.float32), np.ones(4, np.float32),
                          np.ones(4, bool))
    assert d.mem_gb.dtype == np.float32 and len(PI.slice_soa(d, 1, 3)) == 2
    _assert_soa_equal(PI.slice_soa(d, 1, 3), ri.slice_soa(
        ri.DepartureBatch(*(getattr(d, f) for f in d.__dataclass_fields__)),
        1, 3), "slice_soa")
