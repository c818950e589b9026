"""A run with the timed path broken underneath comes out not correct:
once for each fault a serving cell can have (a token altered where it
is produced, half of the batch left out, a decode step that leaves its
state unchanged), on small copies of the cells, on the CPU, each judged
by its real cell's limit. The same runs unbroken come out correct."""
import time

import pytest
import torch

from portbench.harness import Bench, run_cell
from portbench.tests._tiny import CELLS, make_root
from repro_torch.models import transformer as T


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("pb"))


def entry_module(root, cell):
    b = Bench(root)
    return b.module("entries", b.traffic(b.cell(cell)["traffic"])["entry"])


def go(root, cell):
    return run_cell(root, cell, 2 ** 31 + 11, 0.3, False, "cpu",
                    time.perf_counter(), emit=lambda *a: None)


def altered_prefill(make):
    def made(cfg, impl):
        step = make(cfg, impl=impl)
        return lambda params, batch: step(params, batch).roll(1, -1)
    return made


def half_prefill(make):
    def made(cfg, impl):
        step = make(cfg, impl=impl)

        def half(params, batch):
            toks = batch["tokens"]
            out = step(params, {"tokens": toks[:len(toks) // 2]})
            return torch.cat([out, out])
        return half
    return made


def half_serve(serve):
    def served(cfg, params, prompts, gen, impl="naive"):
        out = serve(cfg, params, prompts[:len(prompts) // 2], gen, impl=impl)
        return torch.cat([torch.as_tensor(out)] * 2).numpy()
    return served


def altered_decode(step):
    def decode(cfg, params, cache, tokens, index, impl="naive"):
        logits, cache = step(cfg, params, cache, tokens, index, impl)
        return (logits.roll(1, -1) if index == 10 else logits), cache
    return decode


def stateless_decode(step):
    def decode(cfg, params, cache, tokens, index, impl="naive"):
        keep = {k: v.clone() for k, v in cache["kv"].items()}
        logits, cache = step(cfg, params, cache, tokens, index, impl)
        for k, v in keep.items():
            cache["kv"][k].copy_(v)
        return logits, cache
    return decode


@pytest.mark.parametrize("cell", CELLS)
def test_unbroken_runs_are_correct(root, cell):
    assert go(root, cell)["correct"]


@pytest.mark.parametrize("cell, fault", [
    ("tm.prefill", "altered"), ("tm.prefill", "half"),
    ("tm.decode", "altered"), ("tm.decode", "half"),
    ("tm.decode", "stateless")])
def test_a_broken_path_is_not_correct(root, cell, fault, monkeypatch):
    mod = entry_module(root, cell)
    if cell.endswith("prefill"):
        wrap = {"altered": altered_prefill, "half": half_prefill}[fault]
        monkeypatch.setattr(mod, "make_prefill_step",
                            wrap(mod.make_prefill_step))
    elif fault == "half":
        monkeypatch.setattr(mod, "serve_batch", half_serve(mod.serve_batch))
    else:
        wrap = {"altered": altered_decode, "stateless": stateless_decode}
        monkeypatch.setattr(T, "decode_step", wrap[fault](T.decode_step))
    line = go(root, cell)
    assert not line["correct"], line["checks"]
