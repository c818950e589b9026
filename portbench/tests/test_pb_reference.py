"""The frozen float32 reference against the port's plain paths at small
sizes on the CPU: the teacher-forced forward at every position (the
MoE's capacity drops included) and the cache path's logits after a
prompt."""
import dataclasses

import numpy as np
import pytest
import torch

from portbench.harness import Bench, model_config
from portbench.reference import moe
from portbench.tests._tiny import REPO, TINY
from portbench.weights import make_params
from repro_torch.launch.serve import serve_batch
from repro_torch.models import transformer as T

def tiny(name, **over):
    cfg = model_config(Bench(REPO).config(name))
    return dataclasses.replace(cfg, **{**TINY[name], **over})


def f32(tree):
    if isinstance(tree, dict):
        return {k: f32(v) for k, v in tree.items()}
    return tree.float()


@pytest.mark.parametrize("batch, length, vocab, capacity", [
    # 2 x 1,100 tokens make 4,400 assignments: over 4,096, so the
    # capacity applies; ids from 8 tokens load the experts unevenly
    (2, 1100, 8, True),
    (2, 200, 512, False),
])
def test_reference_matches_the_ports_plain_forward(batch, length, vocab,
                                                   capacity):
    name = "mixtral-8x22b-8l"
    cfg = tiny(name)
    params = make_params(cfg, 3, "cpu")
    tokens = torch.randint(0, vocab, (batch, length),
                           generator=torch.Generator().manual_seed(4))
    hidden = T.forward(cfg, f32(params), {"tokens": tokens}, impl="chunked")
    port = T.logits_from_hidden(cfg, f32(params), hidden)
    (want,) = moe.forward(cfg, params, [tokens], [torch.arange(length)],
                          capacity_factor=1.25)
    assert (port - want).abs().max() < 2e-4 * want.abs().max()
    x = torch.nn.functional.embedding(tokens, params["embed"]["w"])
    x = x.float().reshape(-1, cfg.d_model)
    w = params["layers"]["moe"]["router"]["w"][0]
    _, _, kept = moe.route(w, x / x.pow(2).mean(-1, keepdim=True)
                           .add(1e-5).sqrt(), cfg, 1.25)
    assert kept.all() != capacity, "the capacity dropped nothing"


def test_reference_matches_the_cache_path():
    cfg = tiny("mixtral-8x22b-8l")
    params = make_params(cfg, 5, "cpu")
    prompts = np.random.default_rng(6).integers(0, cfg.vocab_size, (3, 24))
    trace = {}
    serve_batch(cfg, f32(params), prompts, 1, trace=trace)
    (want,) = moe.forward(cfg, params, [torch.as_tensor(prompts)],
                          [torch.tensor([23])])
    # the cache path keeps its keys and values in bf16
    assert (trace["prompt_logits"] - want[:, 0]).abs().max() < 0.05

