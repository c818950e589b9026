"""The port's example twins (`repro_torch.examples`) against the
repository's example scripts, on the CPU.

Each reference script runs as it is (`runpy`), and its module globals
hold the numbers it printed. The quickstart twin must print the same
lines and give equal numbers. The datacenter twin must give equal Table
III metrics, Fig 7 `SimMetrics` (the event backend) and Table IV rows,
and chassis dynamics within the fleet engine's bars against the
reference's numpy engine (rtol 1e-3 on UF p95 latency and NUF slowdown,
`tests/test_fleet_engine.py`).
"""
import dataclasses
import runpy
import warnings
from pathlib import Path

import numpy as np
import pytest

from _torch_parity import reference_serve
from repro_torch.examples import datacenter_sim, quickstart

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _run_reference(name: str) -> dict:
    """Run an example script of the repository; its module globals. The
    quickstart imports `repro.serve`, which warns on the installed jax
    (`_torch_parity.reference_serve`)."""
    reference_serve()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return runpy.run_path(str(EXAMPLES / name))


def test_quickstart_twin_equals_reference(capsys):
    g = _run_reference("quickstart.py")
    ref_out = capsys.readouterr().out
    got = quickstart.main(device="cpu")
    assert capsys.readouterr().out == ref_out
    assert got["history"] == len(g["hist"].vms)
    assert got["uf_share"] == float(g["labels"].mean())
    assert got["chassis_std"] == float(np.std(g["state"].score_chassis()))
    assert got["oversubscription"] == g["res"].oversubscription
    assert got["savings_usd"] == g["res"].savings_usd()
    assert got["admitted"] == g["served"].n_admitted
    assert got["conservative"] == g["served"].n_conservative


def test_datacenter_twin_equals_reference(capsys):
    g = _run_reference("datacenter_sim.py")
    capsys.readouterr()
    got = datacenter_sim.main(device="cpu")
    assert got["table3"] == g["m"]
    for name, want in (("sim_base", g["base"]), ("sim_ours", g["ours"])):
        for f in dataclasses.fields(want):
            a, b = getattr(got[name], f.name), getattr(want, f.name)
            if isinstance(b, np.ndarray):
                np.testing.assert_array_equal(a, b, err_msg=f.name)
            else:
                assert a == b, f"{name}.{f.name}"
    np.testing.assert_allclose(
        got["uf_p95_latency_x"],
        g["rv"].uf_p95_latency / g["nc"].uf_p95_latency, rtol=1e-3)
    np.testing.assert_allclose(got["nuf_slowdown"], g["rv"].nuf_slowdown,
                               rtol=1e-3)
    assert got["oversubscription"] == {
        k: float(r.oversubscription) for k, r in g["rows"].items()}
    out = capsys.readouterr().out
    assert out.count("===") == 8 and "paper: ~2x" in out


def test_twins_need_a_device_or_the_cpu(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod in (quickstart, datacenter_sim):
        with pytest.raises(RuntimeError, match="CUDA"):
            mod.main()
