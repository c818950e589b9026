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
from repro_torch.core.placement import SchedulerPolicy
from repro_torch.runtime.power_control import ChassisPowerSim
from repro_torch.serve.featurizer import empty_table
from repro_torch.sim import chassis_sim, fleet, scheduler_sim
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


def test_evaluation_entry_points_default_to_the_card(no_cuda):
    """The fleet engine, the chassis simulator, the framework power
    control, the scheduler's serve backend and its power evaluation run
    on the card unless asked for the CPU or the numpy oracle."""
    specs = [chassis_sim.paper_single_server_spec()]
    with pytest.raises(RuntimeError, match="CUDA"):
        fleet.run_fleet(specs, 230.0, "per_vm", duration_s=1.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        chassis_sim.simulate_server(specs[0], 230.0, "per_vm", 1.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        ChassisPowerSim(budget_w=260.0)
    spec = scheduler_sim.SimSpec(days=0.05, serve=scheduler_sim.
                                 ServeBackendSpec(backend="serve"))
    with pytest.raises(RuntimeError, match="CUDA"):
        scheduler_sim.simulate(SchedulerPolicy(),
                               scheduler_sim.PredictionChannel(), spec)
    power = scheduler_sim.SimSpec(
        days=0.05, power=scheduler_sim.PowerEvalSpec(budget_w=2000.0))
    with pytest.raises(RuntimeError, match="CUDA"):
        scheduler_sim.simulate(SchedulerPolicy(),
                               scheduler_sim.PredictionChannel(), power)
    with pytest.raises(RuntimeError, match="CUDA"):
        scheduler_sim.evaluate_power_dynamics(
            {0: (0, 8, 0.5, True, 32.0)}, np.arange(24) // 12, 2, 2000.0,
            sample_chassis=1, duration_s=1.0)
    assert fleet.run_fleet(specs, 230.0, "per_vm", duration_s=1.0,
                           backend="numpy").power_w.shape == (1, 5)
    assert ChassisPowerSim(budget_w=260.0, backend="numpy").state is None


def test_streamed_and_emergency_entry_points_default_to_the_card(no_cuda):
    """The emergency plane's tensors and the serve backend with the plane
    on live on the card unless asked for the CPU; the event backend and
    the numpy oracle need no device."""
    from repro_torch.serve import emergency
    with pytest.raises(RuntimeError, match="CUDA"):
        emergency.init_emergency(3)
    with pytest.raises(RuntimeError, match="CUDA"):
        emergency.scatter_samples(3, [0], [1500.0], [1.0])
    cfg = emergency.EmergencyConfig.from_model(1480.0)
    spec = scheduler_sim.SimSpec(
        days=0.05, emergency=cfg,
        serve=scheduler_sim.ServeBackendSpec(backend="serve"))
    with pytest.raises(RuntimeError, match="CUDA"):
        scheduler_sim.simulate(SchedulerPolicy(),
                               scheduler_sim.PredictionChannel(), spec)
    assert emergency.init_emergency(3, device="cpu").rapl.is_cpu
    assert emergency.init_emergency_np(3).rapl.shape == (3,)
    event = scheduler_sim.simulate(
        SchedulerPolicy(), scheduler_sim.PredictionChannel(),
        scheduler_sim.SimSpec(days=0.05, emergency=cfg))
    assert event.placements > 0


def test_mitigation_and_evaluation_entry_points_default_to_the_card(
        no_cuda):
    """The ballooning and adaptive twins' states, a pipeline with both
    planes, the Table II baselines and the example twins live on the card
    unless asked for the CPU; the numpy oracles and the CLI need no
    device."""
    from repro_torch.core import baselines
    from repro_torch.examples import datacenter_sim, quickstart
    from repro_torch.launch import oversubscribe
    from repro_torch.serve import (AdaptiveConfig, BallooningConfig,
                                   EmergencyConfig, PlaneBundle, ServeConfig,
                                   adaptive, ballooning)
    with pytest.raises(RuntimeError, match="CUDA"):
        ballooning.init_ballooning(3)
    with pytest.raises(RuntimeError, match="CUDA"):
        adaptive.init_adaptive(AdaptiveConfig(), 3)
    with pytest.raises(RuntimeError, match="CUDA"):
        baselines.fft_score(np.ones((2, 240), np.float32))
    with pytest.raises(RuntimeError, match="CUDA"):
        baselines.acf_score(np.ones((2, 240), np.float32))
    for mod in (quickstart, datacenter_sim):
        with pytest.raises(RuntimeError, match="CUDA"):
            mod.main()
    pop = generate_population(30, seed=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServePipeline.from_history(
            None, pop, np.zeros(30), n_servers=12, cores_per_server=40,
            blades_per_chassis=12, config=ServeConfig(planes=PlaneBundle(
                emergency=EmergencyConfig.from_model(1860.0),
                ballooning=BallooningConfig(), adaptive=AdaptiveConfig())))
    spec = scheduler_sim.SimSpec(
        days=0.05, adaptive=AdaptiveConfig(),
        serve=scheduler_sim.ServeBackendSpec(backend="serve"))
    with pytest.raises(RuntimeError, match="CUDA"):
        scheduler_sim.simulate(SchedulerPolicy(),
                               scheduler_sim.PredictionChannel(), spec)
    assert ballooning.init_ballooning(3, device="cpu").ballooned_gb.is_cpu
    assert adaptive.init_adaptive_np(AdaptiveConfig(), 3).count.shape == (3,)
    event = scheduler_sim.simulate(
        SchedulerPolicy(), scheduler_sim.PredictionChannel(),
        scheduler_sim.SimSpec(
            days=0.05, emergency=EmergencyConfig.from_model(1480.0),
            ballooning=BallooningConfig()))
    assert event.placements > 0
    assert oversubscribe.main(["--chassis", "2", "--days", "1"]).budget_w > 0


def test_sharded_entry_points_default_to_the_card(no_cuda):
    """The sharded pipeline, its per-shard plane states and the sim's
    serve-sharded backend live on the card unless asked for the CPU."""
    from repro_torch.serve import (AdaptiveConfig, ShardedServeConfig,
                                   ShardedServePipeline, sharding)
    pop = generate_population(30, seed=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardedServePipeline.from_history(
            None, pop, np.zeros(30), n_servers=48, cores_per_server=40,
            blades_per_chassis=12,
            config=ShardedServeConfig(batch_size=32, n_shards=4))
    for init in (sharding.init_emergency_sharded,
                 sharding.init_ballooning_sharded):
        with pytest.raises(RuntimeError, match="CUDA"):
            init(4, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        sharding.init_adaptive_sharded(AdaptiveConfig(), 4, 2)
    spec = scheduler_sim.SimSpec(days=0.05, serve=scheduler_sim.
                                 ServeBackendSpec(backend="serve-sharded",
                                                  shards=4))
    with pytest.raises(RuntimeError, match="CUDA"):
        scheduler_sim.simulate(SchedulerPolicy(),
                               scheduler_sim.PredictionChannel(), spec)
    assert sharding.init_emergency_sharded(4, 2, device="cpu").rapl.shape \
        == (2, 2)


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
            "repro_torch.kernels.flash_attention.ops, repro_torch.sim, "
            "repro_torch.sim.fleet, repro_torch.sim.chassis_sim, "
            "repro_torch.core.capping, repro_torch.core.oversubscription, "
            "repro_torch.runtime.power_control, repro_torch.serve.ingest, "
            "repro_torch.serve.emergency, repro_torch.serve.mitigation, "
            "repro_torch.serve.pipeline, repro_torch.sim.scheduler_sim, "
            "repro_torch.serve.ballooning, repro_torch.serve.adaptive, "
            "repro_torch.core.priority, repro_torch.core.baselines, "
            "repro_torch.core.predictor, repro_torch.launch.oversubscribe, "
            "repro_torch.examples.quickstart, "
            "repro_torch.examples.datacenter_sim; "
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


def test_obs_and_monitor_import_without_jax_or_repro():
    code = ("import sys, repro_torch.obs, repro_torch.obs.audit, "
            "repro_torch.obs.quality, repro_torch.obs.recorder, "
            "repro_torch.obs.registry, repro_torch.obs.slo, "
            "repro_torch.obs.tracing, repro_torch.obs.windows, "
            "repro_torch.launch.monitor; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   env={**os.environ, "PYTHONPATH": str(SRC)})


def test_torch_profile_raises_instead_of_carrying_on(tmp_path):
    """The profiler ships with torch: a trace that cannot be written, or a
    region that fails, raises out of `SpanTracer.torch_profile`."""
    from repro_torch.obs import MetricsRegistry, SpanTracer
    tr = SpanTracer(MetricsRegistry())
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("")
    with pytest.raises(OSError):
        with tr.torch_profile(str(blocker), device="cpu"):
            pass
    with pytest.raises(ZeroDivisionError):
        with tr.torch_profile(str(tmp_path / "ok"), device="cpu"):
            1 / 0
    assert tr.last_profile is None
    with tr.torch_profile(str(tmp_path / "ok"), device="cpu"):
        pass
    assert Path(tr.last_profile).is_file()


def test_monitor_defaults_to_the_card(no_cuda):
    from repro_torch.launch import monitor
    with pytest.raises(RuntimeError, match="CUDA"):
        monitor.main(["--sim", "--days", "0.01"])


def test_train_entry_points_default_to_the_card(no_cuda, tmp_path):
    """The training launcher and both training twins run on the card
    unless asked for the CPU."""
    from repro_torch.examples import serve_capped, train_lm
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "phi4-mini-3.8b", "--reduced", "--steps", "1",
                    "--ckpt-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        train_lm.main(["--steps", "1", "--ckpt-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_capped.main()
    assert not list(tmp_path.iterdir())


def test_training_modules_import_without_jax():
    code = ("import sys, repro_torch.models.loss, repro_torch.optim, "
            "repro_torch.optim.adamw, repro_torch.optim.adafactor, "
            "repro_torch.optim.schedule, repro_torch.optim.grad_compress, "
            "repro_torch.data.pipeline, repro_torch.checkpoint, "
            "repro_torch.runtime.fault_tolerance, repro_torch.launch.train, "
            "repro_torch.examples.train_lm, "
            "repro_torch.examples.serve_capped; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   env={**os.environ, "PYTHONPATH": str(SRC)})
