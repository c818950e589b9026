"""The port's train and eval steps against the JAX package's on the
CPU, for the dense (phi4-mini), ssm (mamba2) and hybrid (zamba2)
families (the moe, audio and vlm families are in
test_torch_train_step_moe.py): reduced configs in float32 on the same
weights, optimizer state and batch, carried across by
`convert.lm_params_from_numpy` and `convert.opt_state_from_numpy`.

Held: the loss and every gradient leaf (`loss_and_grads` against the
reference's `value_and_grad` of the same loss); a whole `make_train_step`
with 1 and 2 micro-batches on loss, grad norm and the updated parameters
where |g| is clear of rounding (the bars and the excused share are in
`_torch_parity`); `make_eval_step`; `grad_compression=True`;
`default_microbatches` on every configuration; remat on and off, and a
donated step against a functional one, bit for bit; and a gradient for
every parameter of every reduced configuration.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from _torch_parity import (as_numpy_leaves, check_grads,  # noqa: E402
                           check_train_step, reference_loss_and_grads,
                           train_case, TRAIN_LOSS_RTOL)
from repro.configs import get_config as j_config  # noqa: E402
from repro.configs.base import SHAPES as J_SHAPES  # noqa: E402
from repro.launch.steps import default_microbatches as j_micro  # noqa: E402
from repro.launch.steps import make_eval_step as j_eval_step  # noqa: E402
from repro.launch.steps import make_train_step as j_train_step  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import SHAPES, ShapeConfig  # noqa: E402
from repro_torch.configs.registry import ARCHS as ALL_ARCHS  # noqa: E402
from repro_torch.launch.steps import (default_microbatches,  # noqa: E402
                                      loss_and_grads, make_eval_step,
                                      make_train_step)
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402

ARCHS = ["phi4-mini-3.8b", "mamba2-2.7b", "zamba2-2.7b"]
#: the largest share of elements a step may excuse (measured 0.17-1.6 %
#: over the seven families, zamba2 the most)
MAX_EXCUSED = 0.02


@pytest.fixture(scope="module")
def reference():
    """arch -> (train_case, the reference's (loss, grads)), built once."""
    cache = {}

    def get(arch):
        if arch not in cache:
            case = train_case(arch)
            _, jcfg, (jp, _, jb), _ = case
            cache[arch] = (case, reference_loss_and_grads(jcfg, jp, jb))
        return cache[arch]
    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(reference, arch):
    (cfg, _, _, (tp, _, tb)), (jl, jg) = reference(arch)
    loss, grads = loss_and_grads(cfg, tp, tb)
    np.testing.assert_allclose(float(loss), float(jl), rtol=TRAIN_LOSS_RTOL)
    check_grads(grads, jg)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("micro", [1, 2])
def test_train_step_matches_reference(reference, arch, micro):
    assert check_train_step(arch, micro, reference(arch)) < MAX_EXCUSED


def test_eval_step_matches_reference(reference):
    (cfg, jcfg, (jp, _, jb), (tp, _, tb)), _ = reference("phi4-mini-3.8b")
    got = make_eval_step(cfg)(tp, tb)
    want = jax.jit(j_eval_step(jcfg))(jp, jb)
    assert not got.requires_grad
    np.testing.assert_allclose(float(got), float(want), rtol=TRAIN_LOSS_RTOL)


def test_grad_compression_step_matches_reference(reference):
    case, (_, jg) = reference("phi4-mini-3.8b")
    cfg, jcfg, (jp, jo, jb), (tp, to, tb) = case
    jp2, _, jm = jax.jit(j_train_step(jcfg, grad_compression=True))(
        jp, jo, jb)
    tp2, _, tm = make_train_step(cfg, grad_compression=True)(tp, to, tb)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    # int8 levels of the two packages' gradients: an element within a
    # level's rounding of a boundary may take the next level
    for g, w, gr in zip(as_numpy_leaves(tp2), as_numpy_leaves(jp2),
                        as_numpy_leaves(jg)):
        clear = np.abs(gr) > 1e-2 * np.abs(gr).max()
        np.testing.assert_allclose(g[clear], w[clear], atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("arch", sorted(ALL_ARCHS))
def test_default_microbatches_equal_reference(arch):
    cfg, jcfg = get_config(arch), j_config(arch)
    shapes = list(SHAPES.values()) + [ShapeConfig("t", 512, 8, "train")]
    jshapes = list(J_SHAPES.values()) + [
        type(next(iter(J_SHAPES.values())))("t", 512, 8, "train")]
    for shape, jshape in zip(shapes, jshapes):
        for n_data in (1, 16, 256):
            assert default_microbatches(cfg, shape, n_data) == \
                j_micro(jcfg, jshape, n_data), (shape, n_data)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_on_and_off_are_bit_equal(reference, arch):
    """Checkpointing each block moves memory, never a number."""
    (cfg, _, _, (tp, _, tb)), _ = reference(arch)
    assert cfg.remat
    l_on, g_on = loss_and_grads(cfg, tp, tb)
    l_off, g_off = loss_and_grads(dataclasses.replace(cfg, remat=False),
                                  tp, tb)
    assert torch.equal(l_on, l_off)
    for a, b in zip(leaves(g_on), leaves(g_off), strict=True):
        assert torch.equal(a, b)


def test_donated_step_equals_functional_step(reference):
    (cfg, _, _, (tp, to, tb)), _ = reference("zamba2-2.7b")
    fp, fo, fm = make_train_step(cfg, microbatches=2)(tp, to, tb)
    dp_in, do_in = (tree_map(lambda t: t.clone(), x) for x in (tp, to))
    dp, do, dm = make_train_step(cfg, microbatches=2, donate=True)(
        dp_in, do_in, tb)
    for a, b in zip(leaves((fp, fo, fm)), leaves((dp, do, dm)), strict=True):
        assert torch.equal(a, b)
    assert leaves(dp)[0].data_ptr() == leaves(dp_in)[0].data_ptr()


@pytest.mark.parametrize("arch", sorted(ALL_ARCHS))
def test_every_reduced_config_differentiates(arch):
    """A grad-enabled forward of each reduced configuration reaches every
    parameter with a finite gradient (MoE included)."""
    cfg = get_config(arch).reduced()
    params = PT.init_params(cfg, 0, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(0)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 16)))
             for k in ("tokens", "labels")}
    if cfg.family == "audio":
        batch["frames"] = torch.randn(2, cfg.encoder_frames, cfg.d_model)
    if cfg.frontend == "vision":
        batch["patch_embeds"] = torch.randn(2, 4, cfg.d_model)
    loss, grads = loss_and_grads(cfg, params, batch)
    assert torch.isfinite(loss)
    for g in leaves(grads):
        assert torch.isfinite(g).all() and g.abs().max() > 0
