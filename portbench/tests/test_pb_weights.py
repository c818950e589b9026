"""Every seed draws the same weights in its own order: each layer's
experts, with their router columns, permuted in place, so that the
experts take the same loads under other indices and the model computes
the same logits."""
import dataclasses

import numpy as np
import pytest
import torch

from portbench.harness import Bench, model_config, seeds
from portbench.reference import moe
from portbench.tests._tiny import REPO, TINY
from portbench.weights import make_params, permute_

NAME = "mixtral-8x22b-8l"


def tiny():
    cfg = model_config(Bench(REPO).config(NAME))
    return dataclasses.replace(cfg, **TINY[NAME])


@pytest.mark.parametrize("perm", [[0, 1, 2, 3], [1, 0, 3, 2], [3, 0, 1, 2],
                                  [2, 3, 0, 1], [0, 2, 3, 1]])
@pytest.mark.parametrize("dim", [0, -1])
def test_permute_puts_each_index_where_the_permutation_says(perm, dim):
    t = torch.randn(4, 3, 4, generator=torch.Generator().manual_seed(1))
    want = t.index_select(dim, torch.tensor(perm))
    permute_(t, np.array(perm), dim)
    assert torch.equal(t, want)


def experts(params, layer):
    moe_ = params["layers"]["moe"]
    return [moe_["router"]["w"][layer], moe_["gate"][layer],
            moe_["up"][layer], moe_["down"][layer]]


def test_the_order_moves_whole_experts_and_keeps_the_logits():
    cfg = tiny()
    base = make_params(cfg, 0, "cpu")
    ordered = make_params(cfg, 0, "cpu", order=np.random.default_rng(7))
    rng, moved = np.random.default_rng(7), 0
    for layer in range(cfg.n_layers):
        perm = torch.as_tensor(rng.permutation(cfg.n_experts))
        moved += int((perm != torch.arange(cfg.n_experts)).sum())
        (rb, *wb), (ro, *wo) = experts(base, layer), experts(ordered, layer)
        assert torch.equal(ro, rb[:, perm])
        for b, o in zip(wb, wo):
            assert torch.equal(o, b[perm])
    assert moved, "no expert moved"
    for key, leaf in (("embed", "w"), ("final_norm", "scale"),
                      ("lm_head", "w")):
        assert torch.equal(base[key][leaf], ordered[key][leaf])
    # 2 x 1,100 tokens over 8 ids: over 4,096 assignments, so the
    # capacity drops some, and unevenly loaded experts
    tokens = torch.randint(0, 8, (2, 1100),
                           generator=torch.Generator().manual_seed(4))
    reads = [torch.arange(1100)]
    (want,) = moe.forward(cfg, base, [tokens], reads, capacity_factor=1.25)
    (got,) = moe.forward(cfg, ordered, [tokens], reads, capacity_factor=1.25)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_every_seed_draws_the_same_experts_in_its_own_order():
    cfg = tiny()
    a, b = seeds(3300000001), seeds(3300000002)
    assert a["weights"] == b["weights"]
    pa = make_params(cfg, a["weights"], "cpu", order=a["order"])
    pb = make_params(cfg, b["weights"], "cpu", order=b["order"])
    assert torch.equal(pa["layers"]["attn"]["wq"]["w"],
                       pb["layers"]["attn"]["wq"]["w"])
    differ = 0
    for layer in range(cfg.n_layers):
        ra, ga = experts(pa, layer)[:2]
        rb, gb = experts(pb, layer)[:2]
        # the same experts: each of a's is one of b's, with its column
        match = [next(j for j in range(cfg.n_experts)
                      if torch.equal(ga[i], gb[j]))
                 for i in range(cfg.n_experts)]
        assert sorted(match) == list(range(cfg.n_experts))
        assert torch.equal(ra, rb[:, match])
        differ += match != list(range(cfg.n_experts))
    assert differ, "two seeds put the experts in the same order"
