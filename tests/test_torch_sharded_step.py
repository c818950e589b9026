"""The fsdp2d train step on 4 gloo ranks of a (2, 2) DeviceMesh against
the plain step on 1 rank, float32, two steps, reduced models: llama3-8b,
mixtral-8x22b and mamba2-2.7b under AdamW, qwen2-vl-72b under Adafactor.

Bars (the training path's, `_torch_parity`): loss within rtol 1e-5, grad
norm within rtol 1e-4, each step's gradient leaf within 1e-5 of its
largest |g|, and the updated parameters within atol 1e-6 + rtol 1e-5
where every step's gradient is clear of rounding (`CLEAR_OF_ROUNDING`;
the key bias, whose gradient is zero in exact arithmetic and rounding
noise that Adam and Adafactor scale up to a full step, is held by its
gradient alone). The ranks sum in another
order than one rank does, so bits may differ. Every rank's shards have
the shapes their specs give; MoE expert ids and dropped sets equal the
1-rank step's but near ties (`test_torch_lm.routing_flips`).

The ranks run in a subprocess (`python -m repro_torch.launch.sharded`):
no process group is made inside a pytest worker."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_parity import CLEAR_OF_ROUNDING, GRAD_REL_ATOL, \
    TRAIN_GNORM_RTOL, TRAIN_LOSS_RTOL, TRAIN_PARAM_TOL
from repro_torch.tree import leaves_with_path
from test_torch_lm import routing_flips

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
#: (arch, batch, seq, micro-batches): mixtral's 2,176 tokens (4,352
#: assignments) pass the dropless limit, so its capacity drops
#: assignments; llama3-8b once more in two micro-batches, each split over
#: the mesh as the batch is
CASES = [("llama3-8b", 4, 16, 1), ("mixtral-8x22b", 8, 272, 1),
         ("mamba2-2.7b", 4, 16, 1), ("qwen2-vl-72b", 4, 16, 1),
         ("llama3-8b", 8, 16, 2)]


def _run(tmp_path, arch, batch, seq, micro):
    out = tmp_path / f"{arch}_{micro}.pt"
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.sharded", "--arch", arch,
         "--reduced", "--mesh", "2,2", "--steps", "2", "--batch",
         str(batch), "--seq", str(seq), "--microbatches", str(micro),
         "--device", "cpu", "--out",
         str(out)], env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return torch.load(out, weights_only=False)


@pytest.mark.parametrize("arch,batch,seq,micro", CASES)
def test_sharded_step_matches_one_rank(tmp_path, arch, batch, seq, micro):
    rec = _run(tmp_path, arch, batch, seq, micro)
    plain, sharded = rec["plain"], rec["sharded"]
    np.testing.assert_allclose(sharded["loss"], plain["loss"],
                               rtol=TRAIN_LOSS_RTOL)
    np.testing.assert_allclose(sharded["grad_norm"], plain["grad_norm"],
                               rtol=TRAIN_GNORM_RTOL)
    assert sharded["shard_errors"] == [[]] * 4
    for g_plain, g_sharded in zip(plain["grads"], sharded["grads"],
                                  strict=True):
        got = dict(leaves_with_path(g_sharded))
        for path, want in leaves_with_path(g_plain):
            want = want.float().numpy()
            np.testing.assert_allclose(
                got[path].float().numpy(), want, rtol=0,
                atol=GRAD_REL_ATOL * max(np.abs(want).max(), 1e-30),
                err_msg=str(path))
    got = dict(leaves_with_path(sharded["params"]))
    grads = [dict(leaves_with_path(g)) for g in plain["grads"]]
    excused = total = 0
    for path, want in leaves_with_path(plain["params"]):
        if path[-2:] == ("wk", "b"):
            # zero gradient in exact arithmetic (the softmax is invariant
            # to a shift along the keys): its update is rounding noise,
            # which the optimizer scales to a full step; its gradient is
            # held above
            continue
        want = want.float().numpy()
        clear = np.ones(want.shape, bool)
        for step in grads:
            gr = np.abs(step[path].float().numpy())
            clear &= (gr > CLEAR_OF_ROUNDING * gr.max()) | (gr == 0)
        err = np.abs(got[path].float().numpy() - want)[clear]
        bar = TRAIN_PARAM_TOL["atol"] \
            + TRAIN_PARAM_TOL["rtol"] * np.abs(want[clear])
        assert (err <= bar).all(), (path, err.max())
        excused += int((~clear).sum())
        total += clear.size
    assert excused <= 0.05 * total
    assert len(sharded["routing"]) == len(plain["routing"])
    if arch.startswith("mixtral"):
        assert len(plain["routing"]) > 0
        k = 2
        flips = routing_flips([r[0].numpy() for r in plain["routing"]],
                              [r[0].numpy() for r in sharded["routing"]], k)
        held = np.setdiff1d(np.arange(batch * seq), sorted(flips))
        assert len(held) >= 0.9 * batch * seq
        dropped = 0
        for (_, ep, kp), (_, es, ks) in zip(plain["routing"],
                                            sharded["routing"]):
            assert torch.equal(ep[held], es[held])
            kp, ks = kp.view(-1, k), ks.view(-1, k)
            if not flips:
                assert torch.equal(kp, ks)
            dropped += int((~kp).sum())
        assert dropped > 0
