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

A prefill's dispatch on plain tensors runs the expert products on each
expert's kept rows; the decode call and a buffer on a mesh (a DTensor)
run them batched over the whole buffer. Both paths compute the same rows
through the same products: the kept-rows path is held to the batched
one here on the CPU, outputs and gradients: bit for bit in bf16, and in
float32 within `F32_SAME` of the largest magnitude (the CPU's float32
products sum in an order that the row count picks), and to the
reference at the bars above.
"""
import json
import math
import os
import subprocess
import sys

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
from repro_torch.obs import tracing as TR  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

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


#: The float32 bar between the two expert paths, relative to the largest
#: magnitude: a few roundings of float32 sums of 64 to 128 terms.
F32_SAME = 1e-6


def _same(got, want, dtype):
    if dtype == "bf16":
        assert torch.equal(got, want)
    else:
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= F32_SAME * scale


#: The kept-rows path's cases: (B, L), capacity factor, dispatch chunk
#: (None: the default), and whether expert 0 is given no assignment.
#: 2 x 1,100 at 0.5 drops assignments; 2 x 500 (2,000 assignments) is a
#: dropless prefill, capacity T*k; 2 x 2,400 runs as two slabs.
KEPT_CASES = {
    "drops": ((2, 1100), 0.5, None, False),
    "dropless_prefill": ((2, 500), 1.25, None, False),
    "idle_expert": ((2, 1100), 1.25, None, True),
    "chunked": ((2, 2400), 0.5, 2400, False),
}


def _kept_case(arch, dtype, case):
    """The layer and input of a `KEPT_CASES` case, for both packages. An
    idle expert 0 gets a router weight of -100 on the first feature,
    which every token holds at 4 or more, so it never makes the top-k."""
    shape, cf, chunk, idle = KEPT_CASES[case]
    cfg, jcfg, jp, tp = _layer(arch, dtype)
    a = np.random.default_rng(6).normal(0, 1, (*shape, cfg.d_model))
    if idle:
        jp = dict(jp, router={"w": jp["router"]["w"].at[0, 0].set(-100.0)})
        tp = dict(tp, router={"w": tp["router"]["w"].clone()})
        tp["router"]["w"][0, 0] = -100.0
        a[..., 0] = 4 + np.abs(a[..., 0])
    j = jnp.asarray(a.astype(np.float32)).astype(DT[dtype][0])
    x = torch.from_numpy(np.array(jnp.asarray(j, jnp.float32))).to(
        DT[dtype][1])
    kw = {"capacity_factor": cf}
    if chunk is not None:
        kw["dispatch_chunk"] = chunk
    return cfg, jcfg, jp, tp, j, x, kw


def _traced(fn, *args, **kw):
    """fn's result and the "experts" spans it recorded under a root."""
    tr = TR.StepTracer(capacity=256)
    with tr.span("prefill_step", device="cpu"):
        out = fn(*args, **kw)
    spans = tr.batches("prefill_step")[0]
    return out, spans[spans["name"] == "experts"]


@pytest.mark.parametrize("case", list(KEPT_CASES))
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ["mixtral-8x22b", "arctic-480b"])
def test_kept_rows_match_batched_and_reference(monkeypatch, arch, dtype,
                                               case):
    """The prefill's kept-rows products give the batched products' output
    (`_same`) and the reference's at its bar; the "experts" spans count
    the kept rows as `rows`, fewer than E*C where the capacity pads."""
    cfg, jcfg, jp, tp, jx, tx, kw = _kept_case(arch, dtype, case)
    want = JM.moe_apply(jp, jx, jcfg, **kw)
    got, experts = _traced(PM.moe_apply, tp, tx, cfg, **kw)
    with monkeypatch.context() as m:
        m.setattr(PM, "_by_expert", lambda *a: False)
        batched, batched_experts = _traced(PM.moe_apply, tp, tx, cfg, **kw)
    _same(got, batched, dtype)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])

    slabs = 2 if case == "chunked" else 1
    assert len(experts) == len(batched_experts) == slabs
    assert (experts["rows"] == experts["kept"]).all()
    assert (batched_experts["kept"] == experts["kept"]).all()
    e, k = cfg.n_experts, cfg.experts_per_token
    slab = tx[:, :tx.shape[1] // slabs]
    r = PM.route(tp, slab.reshape(-1, cfg.d_model), cfg,
                 kw["capacity_factor"])
    assert (batched_experts["rows"] == e * r.capacity).all()
    # at factor 0.5 every expert fills its capacity; at 1.25 some pad
    assert (experts["rows"] <= e * r.capacity).all()
    if kw["capacity_factor"] == 1.25:
        assert (experts["rows"] < e * r.capacity).all()
    if case == "idle_expert":
        assert not (r.expert_ids == 0).any()
    if case == "dropless_prefill":
        assert r.capacity == slab.numel() // cfg.d_model * k
        assert (experts["kept"] == slab.numel() // cfg.d_model * k).all()
    else:
        assert (experts["kept"] < slab.numel() // cfg.d_model * k).all()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ["mixtral-8x22b", "arctic-480b"])
def test_kept_rows_gradients_match_batched(monkeypatch, arch, dtype):
    """The kept-rows path's gradients, of the input and of every weight
    (an idle expert's are zero), equal the batched path's, 2 x 1,100
    tokens at capacity factor 0.5 with expert 0 given none."""
    cfg, _, _, tp, _, tx, kw = _kept_case(arch, dtype, "idle_expert")
    kw["capacity_factor"] = 0.5
    probe = torch.from_numpy(np.random.default_rng(7).normal(
        0, 1, tx.shape).astype(np.float32)).to(tx.dtype)

    def grads():
        leaves = [tx] + [tp[n] for n in ("gate", "up", "down")] \
            + [tp["router"]["w"]]
        xs = [t.detach().requires_grad_() for t in leaves]
        p = dict(tp, gate=xs[1], up=xs[2], down=xs[3], router={"w": xs[4]})
        y = PM.moe_apply(p, xs[0], cfg, **kw)
        return torch.autograd.grad((y.float() * probe.float()).sum(), xs)

    got = grads()
    with monkeypatch.context() as m:
        m.setattr(PM, "_by_expert", lambda *a: False)
        want = grads()
    for g, w in zip(got, want, strict=True):
        _same(g, w, dtype)
    assert not got[1][0].any() and got[1][1:].any()


@pytest.mark.parametrize("call", ["decode", "prefill"])
def test_expert_path_by_call(monkeypatch, call):
    """The decode call (no capacity factor: dropless) keeps the three
    batched products over E*C rows and reads nothing to the host; a
    prefill's dispatch reads the counts once and runs no batched
    product, its `rows` the kept assignments."""
    cfg, _, _, tp = _layer("mixtral-8x22b", "f32")
    shape, cf = ((8, 1), None) if call == "decode" else ((2, 1100), 1.25)
    _, tx = _x(8, (*shape, cfg.d_model), "f32")
    calls = {"bmm": 0, "read": 0}
    bmm, read = torch.bmm, PM._read_counts

    def counting_bmm(*a, **kw):
        calls["bmm"] += 1
        return bmm(*a, **kw)

    def counting_read(n):
        calls["read"] += 1
        return read(n)
    monkeypatch.setattr(torch, "bmm", counting_bmm)
    monkeypatch.setattr(PM, "_read_counts", counting_read)
    _, experts = _traced(PM.moe_apply, tp, tx, cfg, capacity_factor=cf)
    t, e = shape[0] * shape[1], cfg.n_experts
    if call == "decode":
        assert calls == {"bmm": 3, "read": 0}
        assert int(experts["rows"][0]) == e * t * cfg.experts_per_token
    else:
        assert calls == {"bmm": 0, "read": 1}
        assert experts["rows"][0] == experts["kept"][0]


MESH_SCRIPT = r"""
import json, os, tempfile
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate
from repro_torch.configs import get_config
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import MeshSpec, build_mesh
from repro_torch.models import moe as PM
from repro_torch.tree import tree_map

tmp = tempfile.mkdtemp()
dist.init_process_group("gloo", store=dist.FileStore(
    os.path.join(tmp, "store"), 1), rank=0, world_size=1)
mesh = build_mesh(MeshSpec((1, 1), ("data", "model")), "cpu")
strat = shd.make_strategy("fsdp2d", mesh)
cfg = get_config("mixtral-8x22b").reduced()
gen = torch.Generator().manual_seed(0)
params = PM.moe_init(gen, cfg, torch.float32, "cpu")
x = torch.randn((2, 1100, cfg.d_model), generator=gen)
calls = {"bmm": 0, "read": 0}
bmm, read = torch.bmm, PM._read_counts

def counting_bmm(*a, **kw):
    calls["bmm"] += 1
    return bmm(*a, **kw)

def counting_read(n):
    calls["read"] += 1
    return read(n)

torch.bmm, PM._read_counts = counting_bmm, counting_read
plain = PM.moe_apply(params, x, cfg, capacity_factor=1.25)
out = {"plain": dict(calls)}
calls.update(bmm=0, read=0)
rep = [Replicate(), Replicate()]
dp = tree_map(lambda t: DTensor.from_local(t, mesh, rep), params)
with shd.use_strategy(strat, mesh):
    y = PM.moe_apply(dp, DTensor.from_local(x, mesh, rep), cfg,
                     capacity_factor=1.25)
out["mesh"] = dict(calls)
out["is_dtensor"] = isinstance(y, DTensor)
out["max_abs_diff"] = float((y.full_tensor() - plain).abs().max())
out["max_abs"] = float(plain.abs().max())
dist.destroy_process_group()
print("RESULT " + json.dumps(out))
"""


def test_dtensor_buffer_keeps_the_batched_products():
    """On a one-rank gloo mesh (a subprocess: no process group is made
    inside a pytest worker) a prefill dispatch over DTensors keeps the
    three batched products and reads nothing to the host, and gives the
    plain kept-rows path's output within float32 rounding."""
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", MESH_SCRIPT], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("RESULT ")][0]
    out = json.loads(line[len("RESULT "):])
    assert out["plain"] == {"bmm": 0, "read": 1}
    assert out["mesh"] == {"bmm": 3, "read": 0}
    assert out["is_dtensor"]
    assert out["max_abs_diff"] <= 1e-5 * out["max_abs"]
