"""The port's train step against the JAX package's on the CPU for the
moe (mixtral-8x22b; arctic-480b with its dense residual, bf16 gradient
accumulation and Adafactor), audio (whisper-tiny, float32 frames) and
vlm (qwen2-vl-72b with patch embeddings and Adafactor) families; the
dense, ssm and hybrid families and the bars are in
test_torch_train_step.py and `_torch_parity`.

The reduced batches hold 64 tokens, under the dropless limit of 4,096
assignments, so both packages route every assignment; the router is
float32 in both, and no top-k set differs between them here.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from _torch_parity import (check_grads, check_train_step,  # noqa: E402
                           check_training_forms, reference_loss_and_grads,
                           train_case, TRAIN_LOSS_RTOL)
from repro_torch.launch.steps import loss_and_grads  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

ARCHS = ["mixtral-8x22b", "arctic-480b", "whisper-tiny", "qwen2-vl-72b"]
#: as in test_torch_train_step.py
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


def test_arctic_accumulates_in_bf16_and_steps_with_adafactor(reference):
    (cfg, _, _, (tp, to, _)), _ = reference("arctic-480b")
    assert cfg.grad_accum_dtype == "bfloat16"
    assert cfg.optimizer == "adafactor" and "stats" in to
    assert "dense_residual" in tp["layers"]["moe"]


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "qwen2-vl-72b"])
def test_remat_on_and_off_are_bit_equal(reference, arch):
    """MoE dispatch and the vlm's in-place patch write under remat: the
    recomputed forward is the forward, so nothing moves."""
    (cfg, _, _, (tp, _, tb)), _ = reference(arch)
    l_on, g_on = loss_and_grads(cfg, tp, tb)
    l_off, g_off = loss_and_grads(dataclasses.replace(cfg, remat=False),
                                  tp, tb)
    assert torch.equal(l_on, l_off)
    for a, b in zip(leaves(g_on), leaves(g_off), strict=True):
        assert torch.equal(a, b)


def test_vlm_patch_positions_take_no_token_gradient(reference):
    """The patch embeddings overwrite the first positions, so those
    positions' tokens reach the embedding table with no gradient."""
    (cfg, _, _, (tp, _, tb)), _ = reference("qwen2-vl-72b")
    p = tb["patch_embeds"].shape[1]
    only_patched = {k: v.clone() for k, v in tb.items()}
    only_patched["labels"][:] = -1          # no loss at all
    loss, grads = loss_and_grads(cfg, tp, only_patched)
    assert float(loss) == 0.0
    assert not grads["embed"]["w"].any()
    rows = torch.unique(tb["tokens"][:, :p])
    rest = torch.unique(tb["tokens"][:, p:])
    patched_only = rows[~torch.isin(rows, rest)]
    _, grads = loss_and_grads(cfg, tp, tb)
    assert not grads["embed"]["w"][patched_only.long()].any()
    assert grads["embed"]["w"][rest.long()].abs().sum(-1).gt(0).all()


def test_differentiable_forms_keep_the_serving_numbers():
    """The MoE dispatch and the embedding gather became differentiable
    without moving a served number; a remat'd forward is the forward, and
    two backward passes agree bit for bit (on the card too:
    tests/test_torch_kernels_card.py)."""
    check_training_forms(torch.device("cpu"))
