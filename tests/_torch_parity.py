"""Shared helpers of the port's parity tests (`tests/test_torch_*.py`):
hand the JAX package's objects to `repro_torch.convert` as numpy dicts,
import `repro.serve` past its collection-time DeprecationWarning, let the
reference's serve backend take its 64-bit context on the installed jax,
and the `cuda` fixture of the tests that need the card."""
import importlib
import warnings

import numpy as np
import pytest
import torch

from repro_torch.convert import FORESTS


@pytest.fixture
def cuda():
    """The card, for tests marked `cuda`; they skip without one. The
    kernels build and run only there, so the check is made per test, not
    when a module is imported."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels build and run only "
                    "on the card")
    return torch.device("cuda")


def reference_serve(submodule: str | None = None):
    """`repro.serve`, or its `submodule`, imported with the reference's
    jax.experimental.shard_map DeprecationWarning silenced (the repo's
    pytest settings turn it into an error at import time). Submodules are
    looked up by name: after a failed import of `repro.serve` earlier in
    the process (another test file's collection), they stay loaded but
    are no longer attributes of the package."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        pkg = importlib.import_module("repro.serve")
        if submodule is None:
            return pkg
        return importlib.import_module(f"repro.serve.{submodule}")


def service_dict(svc) -> dict:
    """A trained `PredictionService` as `convert.service_from_numpy`
    takes it."""
    forests = (svc.criticality, svc.p95.stage1, svc.p95.low, svc.p95.high)
    d = {name: {"feat_idx": f.feat_idx, "thresholds": f.thresholds,
                "leaf_values": f.leaf_values, "kind": f.kind}
         for name, f in zip(FORESTS, forests)}
    d["confidence_gate"] = svc.confidence_gate
    return d


def table_dict(table) -> dict:
    """A `SubscriptionTable` as `convert.table_from_numpy` takes it."""
    return {f: np.asarray(a) for f, a in zip(table._fields, table)}


def reference_enable_x64(monkeypatch) -> None:
    """Let the reference's `simulate(backend="serve")` run on the installed
    jax: it places inside `jax.experimental.enable_x64()`, which jax 0.9
    removed in favour of `jax.enable_x64(True)`, the same 64-bit context.
    Patched for the calling test only; nothing in `repro` changes."""
    import jax
    import jax.experimental
    monkeypatch.setattr(jax.experimental, "enable_x64",
                        lambda: jax.enable_x64(True), raising=False)


# --- LM training parity (tests/test_torch_train_step*.py) -------------------

#: A train step against the reference's: loss rtol 1e-5, grad norm rtol
#: 1e-4, each gradient leaf within 1e-5 of its largest |g| (the measured
#: worst is 2.2e-6), but the SSD's decay parameters within 1e-4 (measured
#: 1.6e-5 for `a_log`): the port takes the SSD's in-chunk cumsum of A dt in
#: float64 (`kernels/ssd/ref.py`), the reference in float32. Updated
#: parameters are held (atol 1e-6, rtol 1e-5) where |g| > CLEAR_OF_ROUNDING
#: x the leaf's largest |g|: Adam's first step is about lr * sign(g), so an
#: element whose gradient lies within the packages' rounding of zero may
#: move by up to 2 lr between them, and is excused.
TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL, GRAD_REL_ATOL = 1e-5, 1e-4, 1e-5
SSD_DECAY_LEAVES, SSD_DECAY_REL_ATOL = ("a_log", "dt_bias"), 1e-4
CLEAR_OF_ROUNDING = 1e-4
TRAIN_PARAM_TOL = dict(atol=1e-6, rtol=1e-5)


def train_case(arch: str, b: int = 4, s: int = 16, seed: int = 0,
               patches: int = 4):
    """Reduced `arch` in float32 on both packages from the same weights,
    optimizer state and batch: (cfg, jcfg, (jp, jo, jb), (tp, to, tb)).
    The batch holds tokens and labels, and whisper's frames or qwen2-vl's
    patch embeddings, drawn from `seed`."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as j_config
    from repro.models import transformer as JT
    from repro.optim import get_optimizer as j_optimizer
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_from_numpy, opt_state_from_numpy

    cfg, jcfg = get_config(arch).reduced(), j_config(arch).reduced()
    jp = JT.init_params(jcfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    jo = j_optimizer(jcfg.optimizer).init(jp)
    tp = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                              dtype=torch.float32, device="cpu")
    to = opt_state_from_numpy(jax.tree.map(np.asarray, jo), device="cpu")
    rng = np.random.default_rng(seed + 1)
    arrays = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)),
              "labels": rng.integers(0, cfg.vocab_size, (b, s))}
    if cfg.family == "audio":
        arrays["frames"] = rng.normal(0, 1, (b, cfg.encoder_frames,
                                             cfg.d_model))
    if cfg.frontend == "vision":
        arrays["patch_embeds"] = rng.normal(0, 1, (b, patches, cfg.d_model))
    arrays = {k: v.astype(np.int32 if k in ("tokens", "labels")
                          else np.float32) for k, v in arrays.items()}
    jb = {k: jnp.asarray(v) for k, v in arrays.items()}
    tb = {k: torch.from_numpy(v) for k, v in arrays.items()}
    return cfg, jcfg, (jp, jo, jb), (tp, to, tb)


def reference_loss_and_grads(jcfg, jp, jb):
    """The reference's loss and gradients, as its train step takes them
    (`forward` with 'xla_chunked', `chunked_ce`), jitted."""
    import jax
    from repro.models import transformer as JT
    from repro.models.loss import chunked_ce

    def loss_fn(p, mb):
        return chunked_ce(JT.forward(jcfg, p, mb, impl="xla_chunked"),
                          p["lm_head"]["w"], mb["labels"])
    return jax.jit(jax.value_and_grad(loss_fn))(jp, jb)


def as_numpy_leaves(tree) -> list:
    """Leaves of a port tree or a JAX pytree (both in sorted-key order)
    as float32 numpy arrays."""
    import jax
    from repro_torch.tree import leaves
    if isinstance(tree, dict) and any(isinstance(x, torch.Tensor)
                                      for x in leaves(tree)):
        return [t.detach().float().numpy() for t in leaves(tree)]
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


def check_grads(got, want) -> None:
    """Each port gradient leaf within GRAD_REL_ATOL of the reference
    leaf's largest |g| (SSD_DECAY_REL_ATOL for the SSD's decays)."""
    from repro_torch.tree import leaves_with_path
    for (path, g), w in zip(leaves_with_path(got), as_numpy_leaves(want),
                            strict=True):
        bar = SSD_DECAY_REL_ATOL if path[-1] in SSD_DECAY_LEAVES \
            else GRAD_REL_ATOL
        np.testing.assert_allclose(
            g.float().numpy(), w, rtol=0,
            atol=bar * max(np.abs(w).max(), 1e-30), err_msg=str(path))


def check_updated_params(got, want, grads, old, bf16_grads=False) -> float:
    """Updated parameters held where |g| is clear of rounding; returns
    the share of elements excused. With `bf16_grads` (gradients
    accumulated in bf16) an element's gradient is the bf16 sum of bf16
    micro-batch gradients, known only to about two bf16 ulps of the
    leaf's larger gradients (the parts can cancel), so each element is
    also allowed 2^-6 of the leaf's largest update (new - `old`)."""
    excused = total = 0
    for g, w, gr, o in zip(as_numpy_leaves(got), as_numpy_leaves(want),
                           as_numpy_leaves(grads), as_numpy_leaves(old),
                           strict=True):
        # an exact zero (a token row the batch never reads) is no rounding
        clear = (np.abs(gr) > CLEAR_OF_ROUNDING * np.abs(gr).max()) \
            | (gr == 0)
        slack = 2.0 ** -6 * np.abs(w - o).max() if bf16_grads else 0.0
        np.testing.assert_array_less(
            np.abs(g[clear] - w[clear]),
            TRAIN_PARAM_TOL["atol"] + slack
            + TRAIN_PARAM_TOL["rtol"] * np.abs(w[clear]) + 1e-30)
        excused += int((~clear).sum())
        total += clear.size
    return excused / total


def check_train_step(arch: str, micro: int, reference) -> float:
    """`make_train_step` with `micro` micro-batches against the
    reference's, jitted, from one state and batch: loss, grad norm, and
    the updated parameters where |g| is clear of rounding. `reference`
    is (case, (loss, grads)) from `train_case` and
    `reference_loss_and_grads`. Returns the share of elements excused."""
    import jax
    from repro.launch.steps import make_train_step as j_train_step
    from repro_torch.launch.steps import make_train_step

    (cfg, jcfg, (jp, jo, jb), (tp, to, tb)), (_, jg) = reference
    jp2, jo2, jm = jax.jit(j_train_step(jcfg, microbatches=micro))(
        jp, jo, jb)
    tp2, to2, tm = make_train_step(cfg, microbatches=micro)(tp, to, tb)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=TRAIN_LOSS_RTOL)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=TRAIN_GNORM_RTOL)
    assert int(to2["count"]) == int(jo2["count"]) == 1
    return check_updated_params(
        tp2, jp2, jg, jp,
        bf16_grads=micro > 1 and cfg.grad_accum_dtype == "bfloat16")


def moe_dispatch_indexed(params, x, cfg, capacity_factor):
    """`models.moe._moe_dispatch` in its serving-only form: the tokens
    copied in by an indexing gather and the down projections written by
    `bmm(out=)` or `mm(out=)`, which autograd cannot differentiate. Where
    a capacity factor is given the products run expert by expert on the
    kept rows, packed, as the dispatch's own do; without one, batched
    over the whole buffer. The differentiable form must give its numbers
    bit for bit."""
    import torch.nn.functional as F
    from repro_torch.models.moe import route
    b, lc, d = x.shape
    t, e, k = b * lc, cfg.n_experts, cfg.experts_per_token
    xf = x.reshape(t, d)
    r = route(params, xf, cfg, capacity_factor)
    c = r.capacity
    flat_e = r.expert_ids.reshape(-1)
    rows = torch.where(r.keep, flat_e * c + r.pos, e * c)
    tok_ids = torch.arange(t, device=x.device).repeat_interleave(k)
    buf = x.new_zeros((e * c + 1, d))
    buf[rows] = xf[tok_ids]
    if capacity_factor is None:
        buf = buf[:e * c].view(e, c, d)
        h = F.silu(torch.bmm(buf, params["gate"])) \
            * torch.bmm(buf, params["up"])
        out = x.new_empty((e * c + 1, d))
        out[e * c] = 0
        torch.bmm(h, params["down"], out=out[:e * c].view(e, c, d))
    else:
        n = torch.bincount(flat_e[r.keep], minlength=e).tolist()
        start = np.cumsum([0] + n)
        out = x.new_empty((start[-1] + 1, d))
        out[start[-1]] = 0
        for i, m in enumerate(n):
            if m:
                xe = buf[i * c:i * c + m]
                h = F.silu(xe @ params["gate"][i]) * (xe @ params["up"][i])
                torch.mm(h, params["down"][i],
                         out=out[start[i]:start[i] + m])
        rows = torch.where(r.keep, torch.from_numpy(start[:-1]).to(
            x.device)[flat_e] + r.pos, int(start[-1]))
    w = r.gates.reshape(-1, 1).to(x.dtype)
    parts = (out[rows] * w).reshape(t, k, d)
    y = parts[:, 0]
    for j in range(1, k):
        y = y + parts[:, j]
    return y.reshape(b, lc, d)


def check_training_forms(dev) -> None:
    """On `dev`, in bf16 at a reduced width: the differentiable MoE
    dispatch and `F.embedding` give the serving forms' outputs bit for
    bit (dropless and past the capacity), a remat'd block gives the plain
    block's output, and two backward passes give bit-equal gradients."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    from repro_torch.tree import leaves, unflatten

    cfg = get_config("mixtral-8x22b").reduced()
    gen = torch.Generator(device=dev).manual_seed(0)
    p = M.moe_init(gen, cfg, device=dev)
    for t_len, cf in ((16, None), (3000, 1.25)):   # dropless; capacity
        x = torch.randn((2, t_len, cfg.d_model), generator=gen,
                        device=dev).bfloat16()
        assert torch.equal(M._moe_dispatch(p, x, cfg, cf),
                           moe_dispatch_indexed(p, x, cfg, cf))
    table = {"w": torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                              device=dev).bfloat16()}
    toks = torch.randint(0, cfg.vocab_size, (4, 64), generator=gen,
                         device=dev)
    assert torch.equal(L.embed(table, toks), table["w"][toks])

    params = T.init_params(cfg, 1, device=dev)
    batch = {"tokens": torch.randint(0, 64, (4, 128), generator=gen,
                                     device=dev)}

    def grads(remat):
        c = dataclasses.replace(cfg, remat=remat)
        xs = [t.detach().requires_grad_() for t in leaves(params)]
        p = unflatten(params, xs)
        hidden = T.forward(c, p, batch, impl="naive")
        logits = T.logits_from_hidden(c, p, hidden)
        gs = torch.autograd.grad(logits.float().square().mean(), xs)
        return hidden.detach(), gs

    h_plain = T.forward(cfg, params, batch, impl="naive")
    h1, g1 = grads(True)
    h2, g2 = grads(True)
    h3, _ = grads(False)
    assert torch.equal(h1, h_plain) and torch.equal(h1, h3)
    assert torch.equal(h1, h2)
    for a, b in zip(g1, g2, strict=True):
        assert torch.equal(a, b)
