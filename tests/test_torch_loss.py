"""The port's `models.loss.chunked_ce` against the JAX package's on the
same numpy inputs: the loss and its gradients with respect to the hidden
states and the head weight.

Tolerances. In float32 the packages differ only by the order of float32
sums (the logits' products, logsumexp, the chunk totals): rtol 1e-5,
atol 1e-6. In bf16 both round the logits to bf16 before the float32 CE,
at places that can differ by an ulp: the reference's LM bar, atol 0.15,
rtol 0.1 (tests/test_models_smoke.py).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models.loss import chunked_ce as j_chunked_ce  # noqa: E402

from repro_torch.models.loss import chunked_ce  # noqa: E402

F32 = dict(rtol=1e-5, atol=1e-6)
LM_BAR = dict(atol=0.15, rtol=0.1)
DT = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(b, s, d, v, seed, dtype, ignore=0.0):
    rng = np.random.default_rng(seed)
    h = rng.normal(0, 1, (b, s, d)).astype(np.float32)
    w = (rng.normal(0, 1, (d, v)) * d ** -0.5).astype(np.float32)
    y = rng.integers(0, v, (b, s)).astype(np.int32)
    y[rng.random((b, s)) < ignore] = -1
    jdt, tdt = DT[dtype]
    jh, jw = jnp.asarray(h).astype(jdt), jnp.asarray(w).astype(jdt)
    th = torch.from_numpy(np.array(jnp.asarray(jh, jnp.float32))).to(tdt)
    tw = torch.from_numpy(np.array(jnp.asarray(jw, jnp.float32))).to(tdt)
    return (jh, jw, jnp.asarray(y)), (th, tw, torch.from_numpy(y))


def _reference(jh, jw, jy, chunk):
    fn = jax.jit(jax.value_and_grad(
        lambda h, w: j_chunked_ce(h, w, jy, chunk=chunk), argnums=(0, 1)))
    loss, (gh, gw) = fn(jh, jw)
    return [np.asarray(jnp.asarray(a, jnp.float32)) for a in (loss, gh, gw)]


def _port(th, tw, ty, chunk):
    th, tw = th.clone().requires_grad_(), tw.clone().requires_grad_()
    loss = chunked_ce(th, tw, ty, chunk=chunk)
    gh, gw = torch.autograd.grad(loss, (th, tw))
    return [t.detach().float().numpy() for t in (loss, gh, gw)]


@pytest.mark.parametrize("b,s,d,v,chunk,ignore,dtype", [
    (2, 64, 16, 50, 16, 0.0, "f32"),        # chunk 16, S a multiple
    (2, 300, 32, 97, 256, 0.0, "f32"),      # chunk 256, S = 256 + 44
    (3, 37, 16, 40, 16, 0.0, "f32"),        # S not a multiple of 16
    (2, 40, 16, 60, 256, 0.0, "f32"),       # chunk = min(256, S) = S
    (2, 64, 16, 50, 16, 0.4, "f32"),        # labels < 0 ignored
    (2, 64, 16, 50, 16, 1.0, "f32"),        # every label ignored
    (2, 96, 32, 128, 32, 0.2, "bf16"),      # bf16 inputs
])
def test_chunked_ce_and_grads_match_reference(b, s, d, v, chunk, ignore,
                                              dtype):
    (jh, jw, jy), (th, tw, ty) = _inputs(b, s, d, v, b * s + v, dtype,
                                         ignore)
    want = _reference(jh, jw, jy, chunk)
    got = _port(th, tw, ty, chunk)
    tol = F32 if dtype == "f32" else LM_BAR
    for name, g, w in zip(("loss", "d_hidden", "d_head_w"), got, want):
        np.testing.assert_allclose(g, w, err_msg=name, **tol)
    if ignore == 1.0:
        assert got[0] == 0.0 and not np.any(got[1]) and not np.any(got[2])


def test_chunked_ce_matches_direct_float64():
    """The reference's own check: the chunked CE equals the float64 CE
    of the whole logits, here with ignored labels and a padded tail."""
    (_, _, _), (th, tw, ty) = _inputs(2, 50, 16, 40, 3, "f32", 0.3)
    logits = (th.double() @ tw.double())
    lse = torch.logsumexp(logits, -1)
    keep = ty >= 0
    gold = logits.gather(-1, ty.clamp(min=0).long()[..., None])[..., 0]
    want = float(((lse - gold) * keep).sum() / keep.sum())
    assert float(chunked_ce(th, tw, ty, chunk=16)) == pytest.approx(
        want, rel=1e-5)


def test_chunked_ce_under_no_grad_needs_no_checkpoint():
    """Eval runs without autograd: the same value, no graph."""
    (_, _, _), (th, tw, ty) = _inputs(2, 40, 16, 30, 5, "f32")
    with torch.no_grad():
        out = chunked_ce(th, tw, ty, chunk=16)
    assert not out.requires_grad
    assert float(out) == float(chunked_ce(th, tw, ty, chunk=16).detach())
