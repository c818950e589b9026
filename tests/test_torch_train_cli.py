"""The port's training entry points on the CPU: `python -m
repro_torch.launch.train` (losses finite and falling; with injected
failures and checkpoints every 2 steps the final state equals the run
without failures; `--power-capped` throttles the job), the framework
integration of tests/test_system.py (a reduced model trains under the
chassis controller, the batch job throttled, the serving job at full
frequency), and the `train_lm` and `serve_capped` example twins at few
steps."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.examples import serve_capped, train_lm
from repro_torch.launch import train
from repro_torch.launch.steps import make_train_step
from repro_torch.models import transformer as T
from repro_torch.optim import get_optimizer
from repro_torch.runtime.power_control import (ChassisPowerSim, JobSpec,
                                               ThrottledLoop)
from repro_torch.tree import leaves

ARGS = ["--arch", "phi4-mini-3.8b", "--reduced", "--batch", "4", "--seq",
        "32", "--device", "cpu"]


def test_train_cli_losses_finite_and_falling(tmp_path):
    losses = train.main(ARGS + ["--steps", "30", "--ckpt-dir",
                                str(tmp_path)])
    assert len(losses) == 30 and np.all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < losses[0] - 0.5


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "qwen2-vl-72b"])
def test_failures_replay_to_the_state_of_a_run_without(tmp_path, arch):
    """Injected failures rewind to the newest commit (or the pre-loop
    snapshot) and replay each rewound step's own batch, so the final
    state is the failure-free run's, bit for bit (qwen2-vl: Adafactor)."""
    args = ["--arch", arch, "--reduced", "--batch", "2", "--seq", "16",
            "--device", "cpu", "--steps", "12", "--ckpt-every", "2"]
    clean, failed = {}, {}
    train.main(args + ["--ckpt-dir", str(tmp_path / "a")], trace=clean)
    losses = train.main(args + ["--ckpt-dir", str(tmp_path / "b"),
                                "--inject-failures", "0.3", "--seed", "0"],
                        trace=failed)
    assert failed["loop"].state.restarts > 0
    assert len(losses) > 12
    assert [h["step"] for h in clean["history"]] == list(range(12))
    for a, b in zip(leaves(clean["state"]), leaves(failed["state"]),
                    strict=True):
        assert torch.equal(a, b)


def test_train_cli_power_capped_throttles_the_job(tmp_path):
    trace = {}
    losses = train.main(ARGS + ["--steps", "6", "--power-capped",
                                "--chassis-budget", "1500", "--ckpt-dir",
                                str(tmp_path)], trace=trace)
    assert np.all(np.isfinite(losses))
    freqs = [h["freq"] for h in trace["history"]]
    assert min(freqs) < 1.0


def test_training_under_power_cap_converges():
    """tests/test_system.py's framework integration on the port."""
    cfg = get_config("phi4-mini-3.8b").reduced()
    params = T.init_params(cfg, 0, device="cpu")
    opt_state = get_optimizer(cfg.optimizer).init(params)
    step = make_train_step(cfg, impl="naive", lr=1e-3)
    chassis = ChassisPowerSim(budget_w=240.0, device="cpu")
    chassis.register(JobSpec("serve", cores=12, user_facing=True,
                             p95_util=0.6))
    chassis.register(JobSpec("train", cores=28, user_facing=False,
                             p95_util=1.0))
    loop = ThrottledLoop(chassis, "train")
    rng = np.random.default_rng(0)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 32)))
             for k in ("tokens", "labels")}
    losses, freqs = [], []
    for _ in range(12):
        (params, opt_state, m), pw = loop.run_step(step, params, opt_state,
                                                   batch)
        losses.append(float(m["loss"]))
        freqs.append(pw["freq"])
    assert losses[-1] < losses[0]
    assert min(freqs) < 1.0
    assert chassis.job_frequency("serve") == pytest.approx(1.0)


def test_train_lm_twin(tmp_path):
    losses = train_lm.main(["--steps", "25", "--seq", "32", "--device",
                            "cpu", "--ckpt-dir", str(tmp_path)])
    assert len(losses) == 25 and np.mean(losses[-20:]) < losses[0]


def test_serve_capped_twin(capsys):
    out = serve_capped.main(device="cpu")
    assert out["serve_freq"] == 1.0 and out["train_min_freq"] < 1.0
    assert np.all(np.isfinite(out["losses"]))
    assert "chassis budget 245 W" in capsys.readouterr().out
