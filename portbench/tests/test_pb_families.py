"""A model family joins the benchmark as files alone: its weights
(`params/<family>.py`), its step arithmetic (`arithmetic/<family>.py`)
and its reference (`reference/<family>.py`) are found by the family's
name, under a benchmark root first; the MoE weights are the same
tensors as before they moved to their family's file; and a configuration
of a registered `ModelConfig` subclass states the subclass's sizes."""
import dataclasses
import hashlib
import json
import time

import pytest
import torch

from portbench import roofline
from portbench.harness import Bench, CellRun, model_config, run_cell
from portbench.tests._tiny import PB, REPO, TINY
from portbench.weights import EMBED_STD, Maker, make_params
from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig


def tiny(name, **over):
    cfg = model_config(Bench(REPO).config(name))
    return dataclasses.replace(cfg, **{**TINY[name], **over})


def leaves(tree, path=()):
    """(path, tensor) of every leaf, in the tree's key order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, (*path, k))
    else:
        yield path, tree


def moe_params_drawn_in_weights_py(cfg, seed, device):
    """The MoE weights as `weights.py` drew them while it held the MoE
    family's draws itself, kept word for word."""
    def _moe(m: Maker, cfg, lead):
        d, e = cfg.d_model, cfg.n_experts
        dff = cfg.moe_d_ff or cfg.d_ff
        if cfg.moe_dense_residual:
            raise ValueError(f"{cfg.name}: a dense residual is not made here")
        return {"router": {"w": m.normal((*lead, d, e), d ** -0.5,
                                         torch.float32)},
                "gate": m.normal((*lead, e, d, dff), d ** -0.5),
                "up": m.normal((*lead, e, d, dff), d ** -0.5),
                "down": m.normal((*lead, e, dff, d), dff ** -0.5)}

    if cfg.family != "moe":
        raise ValueError(f"{cfg.name}: no weights for family {cfg.family!r}")
    m = Maker(seed, device)
    lead = (cfg.n_layers,)
    layers = {"norm1": m.norm(*lead, cfg.d_model),
              "attn": m.attention(cfg, lead),
              "norm2": m.norm(*lead, cfg.d_model),
              "moe": _moe(m, cfg, lead)}
    params = {"embed": {"w": m.normal((cfg.vocab_size, cfg.d_model),
                                      EMBED_STD)},
              "layers": layers,
              "final_norm": m.norm(cfg.d_model),
              "lm_head": m.dense((), cfg.d_model, cfg.vocab_size)}
    return params


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 11])
def test_moe_weights_are_the_tensors_drawn_before(seed):
    cfg = tiny("mixtral-8x22b-8l")
    got = list(leaves(make_params(cfg, seed, "cpu")))
    want = list(leaves(moe_params_drawn_in_weights_py(cfg, seed, "cpu")))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), path


def test_a_family_without_files_is_refused():
    cfg = tiny("mixtral-8x22b-8l", family="audio")
    with pytest.raises(ValueError, match="no weights for family 'audio'"):
        make_params(cfg, 1, "cpu")
    with pytest.raises(ValueError, match="no step arithmetic"):
        roofline.weight_bytes(cfg)


# --------------------------------------------------------------------------
# a second family, added as files and entries to a copy of BENCHMARK.json
# --------------------------------------------------------------------------

#: llama3-8b at the small widths of `_tiny`, every size its file states.
DENSE = dict(json.loads((PB / "configs/mixtral-8x22b-8l.json").read_text())
             ["model"], family="dense", n_experts=0, sliding_window=None,
             rope_theta=500000.0, **{k: v for k, v in
                                     TINY["mixtral-8x22b-8l"].items()
                                     if k not in ("n_experts",
                                                  "sliding_window")})

PARAMS = '''
from portbench.weights import EMBED_STD, Maker


def make(m: Maker, cfg):
    lead, d = (cfg.n_layers,), cfg.d_model
    layers = {"norm1": m.norm(*lead, d), "attn": m.attention(cfg, lead),
              "norm2": m.norm(*lead, d),
              "mlp": {"gate": m.dense(lead, d, cfg.d_ff),
                      "up": m.dense(lead, d, cfg.d_ff),
                      "down": m.dense(lead, cfg.d_ff, d)}}
    return {"embed": {"w": m.normal((cfg.vocab_size, d), EMBED_STD)},
            "layers": layers, "final_norm": m.norm(d),
            "lm_head": m.dense((), d, cfg.vocab_size)}
'''

REFERENCE = '''
from portbench.reference.common import (attention_block, attention_weights,
                                        embed, full_precision, head, linear,
                                        rmsnorm, silu, take, weight)


def forward(cfg, params, batches, reads, control=False,
            capacity_factor=None):
    full_precision()
    xs = [embed(params, t) for t in batches]
    for li in range(cfg.n_layers):
        lp = take(params["layers"], li)
        attn = attention_weights(lp["attn"], control)
        g, u, dn = (weight(lp["mlp"][n]["w"], control)
                    for n in ("gate", "up", "down"))
        for i, x in enumerate(xs):
            x = x + attention_block(attn, rmsnorm(x, lp["norm1"]["scale"]),
                                    cfg, control)
            h = rmsnorm(x, lp["norm2"]["scale"])
            xs[i] = x + linear(silu(linear(h, g, control))
                               * linear(h, u, control), dn, control)
    return [head(cfg, params, x[:, r], control) for x, r in zip(xs, reads)]
'''

#: The dense step written out whole, apart from the stack functions of
#: the benchmark's own `arithmetic/dense.py`, which it checks.
ARITHMETIC = '''
from portbench import roofline as rf


def prefill_flops(cfg, b, l):
    d, hd = cfg.d_model, cfg.head_dim
    attn = d * (2 * cfg.n_heads + 2 * cfg.n_kv_heads) * hd
    block = 2.0 * b * l * (attn + 3 * d * cfg.d_ff)
    core = rf.flash_ops(b, cfg.n_heads, l, l, hd)
    return cfg.n_layers * (block + core) + 2.0 * b * d * cfg.vocab_size
'''


def snapshot():
    """A digest of every file of the real benchmark."""
    files = [REPO / "BENCHMARK.json"] + sorted(
        p for p in PB.rglob("*") if p.is_file()
        and "__pycache__" not in p.parts)
    return {p: hashlib.sha256(p.read_bytes()).hexdigest() for p in files}


@pytest.fixture(scope="module")
def dense_root(tmp_path_factory):
    """(root, the real benchmark's digest before the root was made):
    BENCHMARK.json with a dense configuration and its prefill cell
    added, and the family's and the cell's files beside it."""
    before = snapshot()
    root = tmp_path_factory.mktemp("dense")
    pb = root / "portbench"
    for kind, text in (("params", PARAMS), ("reference", REFERENCE),
                       ("arithmetic", ARITHMETIC)):
        (pb / kind).mkdir(parents=True)
        (pb / kind / "dense.py").write_text(text)
    for kind in ("configs", "traffic", "limits"):
        (pb / kind).mkdir()
    (pb / "configs/tl.json").write_text(json.dumps(
        {"arch": "llama3-8b", "model": DENSE}))
    mix = json.loads((PB / "traffic/prefill-azure-b4.json").read_text())
    mix.update(impl="chunked", batch=2, lengths=[16, 32], trace_batches=2,
               check={"batches": {"16": 2, "32": 1}})
    (pb / "traffic/tl-prefill.json").write_text(json.dumps(mix))
    (pb / "limits/tl.prefill.json").write_text(
        (PB / "limits/mixtral-8x22b.prefill-azure.json").read_text())
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tl", "source": "arXiv:2407.21783",
                            "file": "portbench/configs/tl.json",
                            "reduced": [], "why": "a small dense model"})
    spec["workloads"].append({"name": "tl.prefill", "config": "tl",
                              "traffic": "tl-prefill", "chips": 1,
                              "why": "a small dense prefill"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root, before


def test_a_second_family_joins_as_files_alone(dense_root):
    root, before = dense_root
    b = Bench(root)
    for kind in ("params", "reference", "arithmetic"):
        assert b.module(kind, "dense").__file__.startswith(str(root))
    line = run_cell(root, "tl.prefill", 2 ** 31 + 5, 0.3, False,
                    "cpu", time.perf_counter(), emit=lambda *a: None)
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {"prefill_tokens_per_s", "ttft_p95_ms",
                                    "setup_s"}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    run = CellRun(b, "tl.prefill", 1, "cpu")
    flops = run.context(0.0).roofline.prefill_flops(run.cfg, 2, 32)
    assert flops == b.module("arithmetic", "dense").prefill_flops(
        run.cfg, 2, 32)
    # the benchmark's own dense arithmetic counts the same
    assert flops == roofline.prefill_flops(run.cfg, 2, 32)
    assert snapshot() == before


# --------------------------------------------------------------------------
# a configuration of a registered subclass of ModelConfig
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SharedBlockConfig(ModelConfig):
    """A family's own sizes, beside ModelConfig's."""
    shared_blocks: int = 1
    lora_rank: int = 0


@pytest.fixture
def shared_arch(monkeypatch):
    """A SharedBlockConfig registered as the port registers an arch."""
    base = registry.get_config("llama3-8b")
    arch = SharedBlockConfig(**dict(dataclasses.asdict(base),
                                    name="tiny-shared"))
    monkeypatch.setitem(registry.ARCHS, arch.name, arch)
    return arch.name


def test_model_config_takes_a_registered_subclass(shared_arch):
    model = dict(DENSE, shared_blocks=2, lora_rank=8)
    cfg = model_config({"arch": shared_arch, "model": model})
    assert isinstance(cfg, SharedBlockConfig)
    assert (cfg.shared_blocks, cfg.lora_rank) == (2, 8)
    assert cfg.d_model == DENSE["d_model"] and cfg.family == "dense"


def test_model_config_refuses_a_subclass_size_left_out(shared_arch):
    model = dict(DENSE, shared_blocks=2)
    with pytest.raises(ValueError, match=r"does not state \['lora_rank'\]"):
        model_config({"arch": shared_arch, "model": model})
