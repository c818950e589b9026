"""The port never carries on quietly on the CPU: without a card, entry
points that were not asked for the CPU raise; asking for the CUDA kernel
on a CPU tensor raises; and `repro_torch` imports without JAX."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import device as D
from repro_torch.configs import get_config
from repro_torch.core import criticality
from repro_torch.launch import serve as lm_serve
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import transformer as T
from repro_torch.serve import ServePipeline, resolve_kernel
from repro_torch.serve.featurizer import empty_table
from repro_torch.sim.telemetry import generate_population

SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_from_history_without_device_raises(no_cuda):
    pop = generate_population(30, seed=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServePipeline.from_history(None, pop, np.zeros(30), n_servers=12,
                                   cores_per_server=40,
                                   blades_per_chassis=4)


def test_entry_points_default_to_the_card(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA"):
        D.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        criticality.classify(np.ones((2, 240), np.float32))
    with pytest.raises(RuntimeError, match="CUDA"):
        empty_table(4)
    assert D.resolve_device("cpu").type == "cpu"


def test_cuda_kernel_on_cpu_tensor_raises():
    x = torch.zeros(4, 18)
    with pytest.raises(ValueError, match="CUDA"):
        resolve_kernel("cuda", x)
    with pytest.raises(ValueError):
        resolve_kernel("pallas", x)
    assert resolve_kernel("auto", x) == "ref"


def test_lm_entry_points_default_to_the_card(no_cuda):
    cfg = get_config("zamba2-2.7b").reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        T.init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.init_cache(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm_serve.main(["--arch", "zamba2-2.7b", "--reduced", "--gen", "1"])
    params = T.init_params(cfg, 0, device="cpu")
    assert params["embed"]["w"].device.type == "cpu"
    assert T.init_cache(cfg, 1, 4, device="cpu")["ssm"]["ssm"].is_cpu


def test_lm_cuda_impl_on_cpu_tensor_raises():
    cfg = get_config("zamba2-2.7b").reduced()
    params = T.init_params(cfg, 0, dtype=torch.float32, device="cpu")
    batch = {"tokens": torch.zeros(1, 8, dtype=torch.long)}
    D.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        make_prefill_step(cfg, impl="cuda")(params, batch)
    with pytest.raises(ValueError, match="impl"):
        make_prefill_step(cfg, impl="pallas")(params, batch)
    assert sum(D.KERNEL_LAUNCHES.values()) == 0


def test_plain_versions_never_count_launches():
    D.reset_launches()
    criticality.classify(np.ones((2, 240), np.float32), device="cpu")
    assert D.KERNEL_LAUNCHES == {"forest": 0, "template": 0,
                                 "flash_attention": 0, "ssd": 0}


def test_import_without_jax():
    code = ("import sys, repro_torch, repro_torch.convert, "
            "repro_torch.serve, repro_torch.core.criticality, "
            "repro_torch.kernels.build, repro_torch.configs, "
            "repro_torch.models.transformer, repro_torch.launch.serve, "
            "repro_torch.launch.steps, repro_torch.kernels.ssd.ops, "
            "repro_torch.kernels.flash_attention.ops; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   env={**os.environ, "PYTHONPATH": str(SRC)})


def test_no_source_imports_jax_or_repro():
    import re
    pat = re.compile(r"^\s*(import|from)\s+(jax|repro)\b", re.M)
    files = list((SRC / "repro_torch").rglob("*.py"))
    files.append(SRC.parent / "chip_smoke.py")
    assert len(files) > 10
    bad = [str(f) for f in files if pat.search(f.read_text())]
    assert not bad
