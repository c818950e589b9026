"""The port's training runtime against the JAX package on the CPU: the
data pipeline (`SyntheticLM` array-equal for the same seed, step, rank
and world; `Prefetcher` in order), the checkpointer (round trip with
bf16, uncommitted steps ignored, rotation, and checkpoints that cross
between the packages both ways for a dense and an MoE train state with
their optimizer states), and the fault-tolerant loop: every case of
tests/test_fault_tolerance.py and the loop cases of
tests/test_substrate.py, on the port's loop, plus its host snapshot."""
import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import Checkpointer as JCheckpointer  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSyntheticLM  # noqa: E402

from _torch_parity import train_case  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.data.pipeline import (DataConfig, Prefetcher,  # noqa: E402
                                       SyntheticLM)
from repro_torch.runtime.fault_tolerance import (  # noqa: E402
    FaultToleranceConfig, FaultTolerantLoop, InjectedFailure, RunState)
from repro_torch.tree import leaves, leaves_with_path  # noqa: E402


# --- data --------------------------------------------------------------------

@pytest.mark.parametrize("seed,step,rank,world", [
    (0, 0, 0, 1), (7, 12, 0, 1), (3, 5, 1, 2), (3, 5, 3, 4), (11, 999, 2, 4)])
def test_synthetic_lm_equals_reference(seed, step, rank, world):
    args = dict(vocab_size=300, seq_len=16, global_batch=8, seed=seed)
    got = SyntheticLM(DataConfig(**args)).batch_at(step, rank, world)
    want = JSyntheticLM(JDataConfig(**args)).batch_at(step, rank, world)
    for k in ("tokens", "labels"):
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(got["labels"][:, :-1], got["tokens"][:, 1:])


def test_prefetcher_in_order():
    src = SyntheticLM(DataConfig(vocab_size=50, seq_len=8, global_batch=2,
                                 seed=1))
    pf = Prefetcher(src, start_step=5, depth=2)
    got = [pf.next() for _ in range(4)]
    pf.close()
    assert [s for s, _ in got] == [5, 6, 7, 8]
    for s, b in got:
        np.testing.assert_array_equal(b["tokens"], src.batch_at(s)["tokens"])
    assert not pf._thread.is_alive()


# --- checkpoint --------------------------------------------------------------

def test_checkpoint_roundtrip_with_bf16(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = {"params": {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
                       "b": torch.ones(3)},
            "step_scale": torch.tensor(2.5),
            "count": torch.tensor(3, dtype=torch.int32),
            "bf16": torch.full((4,), 1.5, dtype=torch.bfloat16) + torch.tensor(
                [0.0, 2 ** -7, -2 ** -6, 3.0], dtype=torch.bfloat16),
            "seq": [torch.zeros(2), torch.ones(1)]}
    ck.save(10, tree)
    restored, step = ck.restore(tree)
    assert step == 10
    for (path, a), b in zip(leaves_with_path(restored), leaves(tree),
                            strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    meta = json.load(open(tmp_path / "step_00000010" / "meta.json"))
    assert meta["keys"]["bf16"]["dtype"] == "bfloat16"
    assert meta["keys"]["count"]["dtype"] == "int32"
    assert set(meta["keys"]) >= {"params/w", "seq/0", "seq/1"}


def test_checkpoint_uncommitted_ignored(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(5, {"w": torch.ones(3)})
    os.makedirs(tmp_path / "step_00000009")       # a partial write
    os.makedirs(tmp_path / "step_00000011.tmp")
    assert ck.latest_step() == 5
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore({"w": torch.ones(3)})


def test_checkpoint_rotation(tmp_path):
    ck = Checkpointer(str(tmp_path), keep_last=2)
    for s in (1, 2, 3, 4):
        ck.save(s, {"w": torch.ones(2) * s})
    assert ck.all_steps() == [3, 4]
    assert float(ck.restore({"w": torch.zeros(2)}, step=3)[0]["w"][0]) == 3.0


def _train_states(arch):
    """A train state {"params", "opt_state"} after one reference update,
    in both packages; params in bf16 as served, the router float32."""
    from repro.launch.steps import make_train_step as j_train_step
    from repro_torch.convert import lm_params_from_numpy, opt_state_from_numpy
    cfg, jcfg, (jp, jo, jb), _ = train_case(arch)
    jp, jo, _ = jax.jit(j_train_step(jcfg))(jp, jo, jb)
    jp = jax.tree_util.tree_map_with_path(
        lambda path, a: a if any(getattr(k, "key", None) == "router"
                                 for k in path) else a.astype(jnp.bfloat16),
        jp)
    jstate = {"params": jp, "opt_state": jo}
    tp = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                              dtype=torch.bfloat16, device="cpu")
    to = opt_state_from_numpy(jax.tree.map(np.asarray, jo), device="cpu")
    return jstate, {"params": tp, "opt_state": to}


def _assert_trees_equal(torch_tree, jax_tree):
    jflat = jax.tree_util.tree_flatten_with_path(jax_tree)[0]
    tflat = leaves_with_path(torch_tree)
    assert len(jflat) == len(tflat)
    for (jpath, j), (tpath, t) in zip(jflat, tflat):
        assert [str(getattr(k, "key", getattr(k, "idx", k))) for k in jpath] \
            == [str(k) for k in tpath]
        want_dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                      "int32": torch.int32}[str(j.dtype)]
        assert t.dtype == want_dtype, tpath
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(j, np.float32), str(tpath))


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "mixtral-8x22b"])
def test_checkpoints_cross_between_packages(tmp_path, arch):
    """Port save -> reference restore, and reference save -> port
    restore: the same keys, dtypes and bits, for a dense and an MoE train
    state (bf16 params with the float32 router, AdamW's m, v and count)."""
    jstate, tstate = _train_states(arch)
    Checkpointer(str(tmp_path / "port")).save(3, tstate)
    got, step = JCheckpointer(str(tmp_path / "port")).restore(jstate)
    assert step == 3
    _assert_trees_equal(tstate, got)
    JCheckpointer(str(tmp_path / "ref")).save(4, jstate)
    got, step = Checkpointer(str(tmp_path / "ref")).restore(tstate)
    assert step == 4
    _assert_trees_equal(got, jstate)
    for a in leaves(got):
        assert a.device.type == "cpu"


# --- fault-tolerant loop -----------------------------------------------------

def _loop(tmp_path, **kw):
    kw.setdefault("checkpoint_every", 5)
    return FaultTolerantLoop(FaultToleranceConfig(**kw),
                             Checkpointer(str(tmp_path)))


def _counting(state, batch):
    return {"x": state["x"] + batch}, float(state["x"])


def test_injected_failure_from_step_fn_restores_and_retries(tmp_path):
    loop = _loop(tmp_path)
    fails = {7: True, 12: True}

    def step_fn(state, batch):
        if fails.pop(int(state["x"]), False):
            raise InjectedFailure("chaos")
        return _counting(state, batch)

    state, history = loop.run({"x": torch.tensor(0.0)}, step_fn,
                              lambda s: 1.0, n_steps=20)
    assert float(state["x"]) == 20.0
    assert loop.state.restarts == 2
    assert len(history) > 20


def test_failure_before_first_commit_rewinds_to_snapshot(tmp_path):
    loop = _loop(tmp_path, checkpoint_every=100)
    seen = []

    def step_fn(state, batch):
        seen.append(float(state["x"]))
        if len(seen) == 3:
            raise InjectedFailure("early")
        return _counting(state, batch)

    state, _ = loop.run({"x": torch.tensor(5.0)}, step_fn,
                        lambda s: 1.0, n_steps=4)
    assert loop.state.restarts == 1
    assert float(state["x"]) == 9.0
    assert seen[3] == 5.0


def test_snapshot_is_a_host_copy_that_survives_in_place_steps(tmp_path):
    """A step that writes into the state (a donated step) must not move
    the snapshot: the rewind before the first commit restores the state
    from before the loop."""
    loop = _loop(tmp_path, checkpoint_every=100)
    calls = []

    def step_fn(state, batch):
        calls.append(1)
        if len(calls) == 3:
            raise InjectedFailure("early")
        state["x"].add_(batch)
        return state, float(state["x"][0])

    x0 = torch.tensor([5.0, 1.0])
    state, history = loop.run({"x": x0}, step_fn, lambda s: 1.0, n_steps=3)
    assert loop.state.restarts == 1
    assert state["x"].tolist() == [8.0, 4.0]
    assert history == [6.0, 7.0, 6.0, 7.0, 8.0]
    assert loop.state.snapshot_s >= 0.0


def test_restart_exhaustion_reraises(tmp_path):
    loop = _loop(tmp_path, max_restarts=3)

    def step_fn(state, batch):
        raise InjectedFailure("always")

    with pytest.raises(InjectedFailure):
        loop.run({"x": torch.tensor(0.0)}, step_fn, lambda s: 1.0,
                 n_steps=5)
    assert loop.state.restarts == 4


def test_real_exception_propagates_without_retry(tmp_path):
    loop = _loop(tmp_path)
    calls = []

    def step_fn(state, batch):
        calls.append(1)
        raise ValueError("real bug")

    with pytest.raises(ValueError, match="real bug"):
        loop.run({"x": torch.tensor(0.0)}, step_fn, lambda s: 1.0,
                 n_steps=5)
    assert len(calls) == 1
    assert loop.state.restarts == 0


@pytest.mark.parametrize("rate,seed,every,n", [(0.3, 7, 4, 16),
                                               (0.15, 3, 5, 40)])
def test_injection_rate_draws_from_seeded_rng(tmp_path, rate, seed, every,
                                              n):
    """The loop's own chaos channel (tests/test_fault_tolerance.py and
    tests/test_substrate.py's cases): restarts happen, the run lands on
    the exact final state, and the draws are the reference's."""
    from repro.checkpoint import Checkpointer as JCk
    from repro.runtime.fault_tolerance import (
        FaultToleranceConfig as JCfg, FaultTolerantLoop as JLoop)
    cfg = dict(checkpoint_every=every, inject_failure_rate=rate)
    loop = FaultTolerantLoop(FaultToleranceConfig(**cfg),
                             Checkpointer(str(tmp_path / "p")), rng_seed=seed)
    state, hist = loop.run({"x": torch.tensor(0.0)}, _counting,
                           lambda s: 1.0, n_steps=n)
    assert loop.state.restarts > 0
    assert float(state["x"]) == float(n)
    jloop = JLoop(JCfg(**cfg), JCk(str(tmp_path / "j")), rng_seed=seed)
    _, jhist = jloop.run({"x": jnp.asarray(0.0)}, _counting, lambda s: 1.0,
                         n_steps=n)
    assert jloop.state.restarts == loop.state.restarts
    assert jhist == hist


def test_checkpoints_commit_on_cadence(tmp_path):
    ck = Checkpointer(str(tmp_path))
    loop = FaultTolerantLoop(FaultToleranceConfig(checkpoint_every=4), ck)
    loop.run({"x": torch.tensor(0.0)}, _counting, lambda s: 1.0,
             n_steps=10)
    assert ck.latest_step() == 8


def test_resume_or_init_cold_and_warm(tmp_path):
    ck = Checkpointer(str(tmp_path))
    loop = FaultTolerantLoop(FaultToleranceConfig(), ck)
    state, start = loop.resume_or_init(lambda: {"x": torch.tensor(1.0)})
    assert start == 0 and float(state["x"]) == 1.0
    ck.save(6, {"x": torch.tensor(42.0)})
    state, start = loop.resume_or_init(lambda: {"x": torch.tensor(1.0)})
    assert start == 6 and float(state["x"]) == 42.0


def _bare_loop(**kw):
    return FaultTolerantLoop(FaultToleranceConfig(**kw),
                             Checkpointer.__new__(Checkpointer))


@pytest.mark.parametrize("slow,patience,want", [
    ([0.5] * 6, 3, "fires"), ([0.5] * 4, 2, "fires"),
    ([0.5, 0.1] * 4, 2, "never")])
def test_straggler_deadline(slow, patience, want):
    """Steps slower than factor x the rolling median for `patience`
    consecutive beats fire the mitigation and rearm the counter; a single
    on-deadline beat resets patience."""
    loop = _bare_loop(straggler_factor=2.0, straggler_patience=patience)
    hits = []
    loop.on_straggler = lambda s: hits.append(s.mitigations)
    for dt in [0.1] * 20 + slow:
        loop._track_straggler(dt)
        loop.state.step_times.append(dt)
    if want == "fires":
        assert loop.state.mitigations >= 1 and hits
    else:
        assert loop.state.mitigations == 0
        assert loop.state.straggler_steps == 0


def test_no_deadline_before_any_history():
    loop = _bare_loop(straggler_factor=2.0, straggler_patience=1)
    loop._track_straggler(999.0)
    assert loop.state.mitigations == 0
    assert RunState().median_step_time() == float("inf")


def test_median_uses_trailing_window():
    st = RunState(step_times=[0.1] * 50 + [1.0] * 50)
    assert st.median_step_time() == pytest.approx(1.0)
