"""The port's MoE layer (`repro_torch.models.moe`) against the JAX
package's `repro.models.moe` on the CPU, on the same numpy inputs and
the same weights (the JAX `moe_init` tree carried across as float32
numpy arrays, the router kept float32 as the reference keeps it), at
reduced mixtral-8x22b and arctic-480b widths (d 64, 4 experts, top-2).

The routing is held exactly: the expert ids equal the reference's (its
`jax.lax.top_k` output, recorded), and the kept assignments equal the
capacity rule applied to them in flat (token, slot) order, computed here
by a plain loop. Outputs: atol/rtol 1e-4 in float32 (the two packages
differ only in the order of float32 sums), and the reference's bf16
prefill bar, atol 0.15 / rtol 0.1 (tests/test_models_smoke.py), in bf16.
"""
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_config  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.models import moe as PM  # noqa: E402

DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16,
                                                    torch.bfloat16)}
TOL = {"f32": dict(atol=1e-4, rtol=1e-4), "bf16": dict(atol=0.15, rtol=0.1)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tree(tree, dtype):
    """A JAX param subtree as torch tensors: float32 leaves stay float32."""
    if isinstance(tree, dict):
        return {k: _tree(v, dtype) for k, v in tree.items()}
    t = torch.from_numpy(np.array(jnp.asarray(tree, jnp.float32)))
    return t if tree.dtype == jnp.float32 else t.to(dtype)


def _layer(arch, dtype, seed=0):
    cfg = get_config(arch).reduced()
    jcfg = j_config(arch).reduced()
    jp = JM.moe_init(jax.random.PRNGKey(seed), jcfg, DT[dtype][0])
    return cfg, jcfg, jp, _tree(jp, DT[dtype][1])


def _x(seed, shape, dtype):
    a = np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)
    j = jnp.asarray(a).astype(DT[dtype][0])
    return j, torch.from_numpy(np.array(jnp.asarray(j, jnp.float32))).to(
        DT[dtype][1])


def _reference_ids(monkeypatch):
    """Record the expert ids of every `jax.lax.top_k` the reference calls
    while it runs eagerly."""
    seen = []
    top_k = jax.lax.top_k

    def recording(x, k):
        vals, ids = top_k(x, k)
        seen.append(np.asarray(ids))
        return vals, ids
    monkeypatch.setattr(jax.lax, "top_k", recording)
    return seen


def _keep_by_loop(ids: np.ndarray, e: int, capacity: int) -> np.ndarray:
    """The capacity rule, one assignment at a time in (token, slot)
    order: kept while its expert has taken fewer than `capacity`."""
    taken = np.zeros(e, np.int64)
    keep = []
    for ex in ids.reshape(-1):
        keep.append(taken[ex] < capacity)
        taken[ex] += 1
    return np.array(keep)


@pytest.mark.parametrize("capacity_factor", [None, 1.25, 0.5])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ["mixtral-8x22b", "arctic-480b"])
def test_moe_apply_matches_reference(monkeypatch, arch, dtype,
                                     capacity_factor):
    """2 x 1,100 tokens: 4,400 assignments, past the dropless 4,096, so
    capacity 1.25 gives 1,375 a slot and 0.5 gives 550, which drops."""
    cfg, jcfg, jp, tp = _layer(arch, dtype)
    jx, tx = _x(1, (2, 1100, cfg.d_model), dtype)
    seen = _reference_ids(monkeypatch)
    want = JM.moe_apply(jp, jx, jcfg, capacity_factor=capacity_factor)
    got = PM.moe_apply(tp, tx, cfg, capacity_factor=capacity_factor)
    assert got.shape == tx.shape and got.dtype == tx.dtype
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])

    r = PM.route(tp, tx.reshape(-1, cfg.d_model), cfg, capacity_factor)
    assert len(seen) == 1
    np.testing.assert_array_equal(r.expert_ids.numpy(), seen[0])
    t, k, e = 2200, cfg.experts_per_token, cfg.n_experts
    cap = t * k if capacity_factor is None else \
        math.ceil(int(capacity_factor * k * t) / e)
    assert r.capacity == cap
    np.testing.assert_array_equal(r.keep.numpy(),
                                  _keep_by_loop(seen[0], e, cap))
    assert r.logits.dtype == r.gates.dtype == torch.float32
    if capacity_factor == 0.5:
        assert not r.keep.all()
    if capacity_factor is None:
        assert r.keep.all()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_moe_dispatch_chunks_like_reference(dtype):
    """A dispatch chunk of 2,400 tokens over 2 x 2,400: two length slabs
    of 2 x 1,200, each with its own capacity (600 at factor 0.5). The
    chunked result is the reference's scan, and not the unchunked one."""
    cfg, jcfg, jp, tp = _layer("mixtral-8x22b", dtype, seed=2)
    jx, tx = _x(3, (2, 2400, cfg.d_model), dtype)
    want = JM.moe_apply(jp, jx, jcfg, capacity_factor=0.5,
                        dispatch_chunk=2400)
    got = PM.moe_apply(tp, tx, cfg, capacity_factor=0.5, dispatch_chunk=2400)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    whole = PM.moe_apply(tp, tx, cfg, capacity_factor=0.5)
    assert not torch.equal(got, whole)
    # a length the chunk does not divide runs as one dispatch
    ragged = PM.moe_apply(tp, tx[:, :2300], cfg, capacity_factor=0.5,
                          dispatch_chunk=2400)
    assert torch.equal(ragged, PM.moe_apply(tp, tx[:, :2300], cfg,
                                            capacity_factor=0.5))


def test_aux_load_balance_loss_matches_reference():
    rng = np.random.default_rng(4)
    logits = rng.normal(0, 2, (300, 8)).astype(np.float32)
    ids = rng.integers(0, 8, (300, 2))
    got = PM.aux_load_balance_loss(torch.from_numpy(logits),
                                   torch.from_numpy(ids), 8)
    want = JM.aux_load_balance_loss(jnp.asarray(logits), jnp.asarray(ids), 8)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "arctic-480b"])
def test_router_stays_float32_through_convert(arch):
    """In a bf16 model the router's `w` (a leaf named like every dense
    weight) crosses over in float32 and bit for bit; the experts in bf16."""
    cfg = get_config(arch).reduced()
    jp = JT.init_params(j_config(arch).reduced(), jax.random.PRNGKey(5))
    tp = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                              device="cpu")
    moe = tp["layers"]["moe"]
    assert moe["router"]["w"].dtype == torch.float32
    np.testing.assert_array_equal(moe["router"]["w"].numpy(),
                                  np.asarray(jp["layers"]["moe"]["router"]
                                             ["w"]))
    for name in ("gate", "up", "down"):
        assert moe[name].dtype == torch.bfloat16
    assert tp["layers"]["attn"]["wq"]["w"].dtype == torch.bfloat16
    mine = PM.moe_init(torch.Generator().manual_seed(0), cfg, device="cpu",
                       lead=(2,))
    assert mine["router"]["w"].dtype == torch.float32
    assert mine["gate"].shape == (2, cfg.n_experts, cfg.d_model,
                                  cfg.moe_d_ff)
    assert mine["down"].shape == (2, cfg.n_experts, cfg.moe_d_ff,
                                  cfg.d_model)
    assert ("dense_residual" in mine) == cfg.moe_dense_residual
