"""The traced run's readings from a synthetic trace: busy time as the
union of device spans, kernel time by name, launch calls, the idle gaps
by what the host was doing; and a traced run of each small cell reports
its per-layer metrics, none of them a share above 100 %."""
import time

import pytest

import portbench.harness as H
from portbench import trace as TR
from portbench.tests._tiny import CELLS, make_root

S = TR.Span


def test_busy_is_the_union_of_device_spans():
    t = TR.Trace([S("flash_kernel_bf16<80>", 10, 20), S("gemm", 15, 30),
                  S("ssd_kernel_bf16", 50, 60)],
                 [S("cudaLaunchKernel", 0, 5), S("cuLaunchKernelEx", 42, 45),
                  S("cudaStreamSynchronize", 60, 80)], 1e-7)
    assert t.busy == [(10, 30), (50, 60)] and t.busy_s == 30e-9
    assert t.kernel_s("flash_kernel", "no_key_rows_kernel") == (10e-9, 1)
    assert t.launch_calls == 2
    b = t.breakdown()
    assert b["device_ops"][0] == ["gemm", 15e-9]
    assert dict(map(tuple, b["idle_gaps"])) == {
        "in cudaLaunchKernel": 10e-9, "host before ssd_kernel_bf16": 20e-9,
        "in cudaStreamSynchronize": 20e-9}


def fake_traced(fn):
    """fn() under a stand-in profiler: every record's batch becomes one
    device span of each kernel kind the readers look for."""
    t0 = time.perf_counter()
    out = fn()
    window = time.perf_counter() - t0
    dev, host, at = [], [], 0
    for r in out:
        for name in ("flash_kernel_bf16", "ssd_kernel_bf16", "gemm"):
            dev.append(S(name, at, at + 10 ** 6))
            host.append(S("cudaLaunchKernel", at - 1000, at - 500))
            at += 2 * 10 ** 6
    return out, TR.Trace(dev, host, window)


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reports_the_cells_per_layer_metrics(
        cell, tmp_path, monkeypatch):
    import portbench.trace
    monkeypatch.setattr(portbench.trace, "traced", fake_traced)
    root = make_root(tmp_path)
    line = H.run_cell(root, cell, 5, 0.3, True, "cpu", time.perf_counter(),
                      emit=lambda *a: None)
    want = {m["name"] for m in H.Bench(root).metrics(cell, "per_layer")}
    assert set(line["metrics"]) == want
    for name, m in line["metrics"].items():
        assert m["value"] >= 0
        if m["unit"] == "%" and "idle" not in name:
            assert m["value"] <= 100
    assert 0 < line["device"]["busy_s"] and line["device"]["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(line)[-1] == "checks"
