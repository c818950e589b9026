"""The port's optimizers, schedule and gradient compression against the
JAX package's on the same numpy inputs.

One update of each optimizer starts from the same parameters, gradients
and state (a state a few reference updates old, carried across by
`convert.opt_state_from_numpy`, so the moments and the count are not
trivial). The reference runs op by op (not jitted), so neither side
fuses a multiply-add: in float32 the results agree to rtol 1e-6 / atol
1e-7 (pow, rsqrt and means may differ by an ulp); bf16 parameters within
one bf16 ulp of the reference's. The schedule and the int8 compression
are equal.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import optim as JO  # noqa: E402
from repro.optim.adamw import clip_by_global_norm as j_clip  # noqa: E402
from repro.optim.adamw import global_norm as j_global_norm  # noqa: E402
from repro.optim import grad_compress as JGC  # noqa: E402
from repro.optim.schedule import cosine_schedule as j_cosine  # noqa: E402

from repro_torch import optim as PO  # noqa: E402
from repro_torch.convert import opt_state_from_numpy  # noqa: E402
from repro_torch.optim.adamw import clip_by_global_norm, global_norm  # noqa
from repro_torch.optim import grad_compress as PGC  # noqa: E402
from repro_torch.optim.schedule import cosine_schedule  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402

F32 = dict(rtol=1e-6, atol=1e-7)
SHAPES = {"a": (4, 8), "b": {"c": (3, 5, 6), "d": (7,)}, "e": (2, 3, 4, 5)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _trees(seed, scale=1.0, dtype=jnp.float32):
    """The same tree in both packages (rounded once to dtype)."""
    rng = np.random.default_rng(seed)

    def make(shapes):
        if isinstance(shapes, dict):
            pairs = {k: make(v) for k, v in shapes.items()}
            return ({k: p[0] for k, p in pairs.items()},
                    {k: p[1] for k, p in pairs.items()})
        j = jnp.asarray(rng.normal(0, scale, shapes).astype(np.float32)
                        ).astype(dtype)
        t = torch.from_numpy(np.array(jnp.asarray(j, jnp.float32)))
        return j, t.to(torch.bfloat16 if dtype == jnp.bfloat16
                       else torch.float32)
    return make(SHAPES)


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, **tol):
    for g, w in zip(leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(_np(g), _np(w), **tol)


def _bf16_ulp_close(got, want):
    for g, w in zip(leaves(got), jax.tree.leaves(want)):
        g, w = _np(g), _np(w)
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
        assert np.all(np.abs(g - w) <= ulp), np.max(np.abs(g - w) / ulp)


def _warm_state(j_opt, jp, steps=3):
    """A reference state after `steps` updates from other gradients."""
    st = j_opt.init(jp)
    for i in range(steps):
        jg, _ = _trees(100 + i, 0.5)
        jg = jax.tree.map(lambda g, p: g.astype(p.dtype), jg, jp)
        _, st, _ = j_opt.update(jg, st, jp, 1e-3)
    return st


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("clip", [1.0, 100.0])
def test_one_update_matches_reference(name, dtype, clip):
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    jp, tp = _trees(0, 1.0, jdt)
    jg, tg = _trees(1, 0.3, jdt)
    j_opt = JO.get_optimizer(name, clip_norm=clip)
    p_opt = PO.get_optimizer(name, clip_norm=clip)
    jst = _warm_state(j_opt, jp)
    tst = opt_state_from_numpy(_numpy_tree(jst), device="cpu")
    jp2, jst2, jn = j_opt.update(jg, jst, jp, 3e-4)
    tp2, tst2, tn = p_opt.update(tg, tst, tp, 3e-4)
    np.testing.assert_allclose(_np(tn), _np(jn), rtol=1e-6)
    assert int(tst2["count"]) == int(jst2["count"]) == 4
    assert tst2["count"].dtype == torch.int32
    if dtype == "f32":
        _close(tp2, jp2, **F32)
    else:
        _bf16_ulp_close(tp2, jp2)
        assert all(t.dtype == torch.bfloat16 for t in leaves(tp2))
    state = "m" if name == "adamw" else "stats"
    _close(tst2[state], jst2[state], **F32)
    if name == "adamw":
        _close(tst2["v"], jst2["v"], **F32)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_donated_update_writes_into_the_old_tensors(name):
    """donate=True gives the functional update's values, in the old
    tensors; donate=False leaves the inputs untouched."""
    _, tp = _trees(0)
    _, tg = _trees(1, 0.3)
    opt = PO.get_optimizer(name)
    st = opt.init(tp)
    before = tree_map(lambda t: t.clone(), tp)
    fp, fst, _ = opt.update(tg, st, tp, 1e-2)
    for a, b in zip(leaves(tp), leaves(before)):
        assert torch.equal(a, b)
    dp, dst, _ = opt.update(tg, st, tp, 1e-2, donate=True)
    for a, b, c in zip(leaves(dp), leaves(fp), leaves(tp)):
        assert torch.equal(a, b) and a.data_ptr() == c.data_ptr()
    for a, b in zip(leaves(dst), leaves(fst)):
        assert torch.equal(a, b)


def test_global_norm_and_clipping_at_and_below_the_norm():
    jg, tg = _trees(2, 2.0)
    np.testing.assert_allclose(_np(global_norm(tg)),
                               _np(j_global_norm(jg)), rtol=1e-6)
    norm = float(global_norm(tg))
    for max_norm in (norm * 0.25, norm, norm * 4.0):
        tc, tn = clip_by_global_norm(tg, max_norm)
        jc, jn = j_clip(jg, max_norm)
        _close(tc, jc, **F32)
        np.testing.assert_allclose(_np(global_norm(tc)),
                                   min(max_norm, norm), rtol=1e-5)
    # at or above the norm the gradients pass through unchanged
    tc, _ = clip_by_global_norm(tg, norm * 4.0)
    for a, b in zip(leaves(tc), leaves(tg)):
        assert torch.equal(a, b)


def test_cosine_schedule_equals_reference():
    for base, warm, total in ((3e-4, 10, 100), (1e-3, 0, 50),
                              (2e-4, 100, 80)):
        j_lr, t_lr = j_cosine(base, warm, total), cosine_schedule(base, warm,
                                                                  total)
        for step in list(range(0, 130, 3)) + [warm, total, total + 5]:
            got, want = t_lr(step), j_lr(step)
            assert got.dtype == torch.float32
            assert _np(got) == _np(want), (base, warm, total, step)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_compress_decompress_and_error_feedback_equal_reference(dtype):
    jg, tg = _trees(3, 0.7, dtype)
    got, want = PGC.compress_decompress(tg), JGC.compress_decompress(jg)
    for g, w in zip(leaves(got), jax.tree.leaves(want)):
        assert np.array_equal(_np(g), _np(w))
    j_init, j_apply = JGC.make_error_feedback()
    t_init, t_apply = PGC.make_error_feedback()
    je, te = j_init(jg), t_init(tg)
    for i in range(3):
        jg_i, tg_i = _trees(10 + i, 0.7, dtype)
        jc, je = j_apply(jg_i, je)
        tc, te = t_apply(tg_i, te)
        for g, w in zip(leaves(tc) + leaves(te),
                        jax.tree.leaves(jc) + jax.tree.leaves(je)):
            assert np.array_equal(_np(g), _np(w))


def test_get_optimizer():
    assert PO.get_optimizer("adamw").init is not None
    st = PO.get_optimizer("adafactor").init({"w": torch.zeros(3, 4),
                                             "b": torch.zeros(4)})
    assert st["stats"]["w"]["vr"].shape == (3,)
    assert st["stats"]["w"]["vc"].shape == (4,)
    assert st["stats"]["b"]["v"].shape == (4,)
    with pytest.raises(KeyError):
        PO.get_optimizer("sgd")


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_descends_quadratic(name):
    """tests/test_substrate.py's case on the port."""
    opt = PO.get_optimizer(name)
    params = {"w": torch.full((4, 8), 3.0)}
    state = opt.init(params)

    def loss(p):
        return torch.sum(p["w"] ** 2)

    l0 = float(loss(params))
    for _ in range(50):
        grads = {"w": 2 * params["w"]}
        params, state, gnorm = opt.update(grads, state, params, 0.05)
    assert float(loss(params)) < l0 * 0.5
    assert np.isfinite(float(gnorm))


@pytest.mark.parametrize("donate", [False, True])
def test_adamw_slabs_give_the_whole_leaf_update(monkeypatch, donate):
    """The update is elementwise: in slabs of a few rows (as a full-width
    leaf is updated) it is the whole leaf's update bit for bit."""
    import importlib
    adamw_mod = importlib.import_module("repro_torch.optim.adamw")
    _, tp = _trees(4)
    _, tg = _trees(5, 0.3)
    opt = PO.get_optimizer("adamw")
    st = opt.init(tp)
    whole = opt.update(tg, st, tp, 1e-2)
    monkeypatch.setattr(adamw_mod, "SLAB_ELEMENTS", 7)
    assert len(adamw_mod.slabs((3, 5, 6))) == 3
    copies = [tree_map(lambda t: t.clone(), x) for x in (tp, st)]
    sliced = opt.update(tg, copies[1], copies[0], 1e-2, donate=donate)
    for a, b in zip(leaves(whole), leaves(sliced), strict=True):
        assert torch.equal(a, b)
