"""Cells, configurations, traffic and metrics are found by name, so a
later change adds them as files and entries alone; and BENCHMARK.json
keeps to the benchmark's contract."""
import json
import re
import time

import pytest

from portbench import roofline
from portbench.harness import Bench, model_config, run_cell
from portbench.tests._tiny import PB, REPO, make_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def spec():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_every_cell_finds_its_files():
    b = Bench(REPO)
    for w in b.spec["workloads"]:
        cfg = model_config(b.config(w["config"]))
        traffic = b.traffic(w["traffic"])
        assert hasattr(b.module("entries", traffic["entry"]), "Entry")
        assert hasattr(b.module("reference", cfg.family), "forward")
        assert callable(b.module("params", cfg.family).make)
        steps = b.module("arithmetic", cfg.family)
        assert all(callable(getattr(steps, f)) for f in roofline.STEPS)
        limits = b.limits(w["name"])
        assert limits and all(v["lower"] < v["limit"] < v["upper"]
                              for v in limits.values())
        for kind in ("end_to_end", "per_layer"):
            for m in b.metrics(w["name"], kind):
                assert callable(b.module("metrics", m["name"]).read)


def test_a_configuration_mix_metric_and_cell_added_as_files(tmp_path):
    root = make_root(tmp_path)
    s = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "portbench/configs/tm.json").read_text())
    cfg["model"]["n_layers"] = 1
    (root / "portbench/configs/tm1.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "portbench/traffic/t.prefill-azure-b4.json")
                     .read_text())
    mix.update(lengths=[24], check={"batches": {"24": 1}})
    (root / "portbench/traffic/flat-24.json").write_text(json.dumps(mix))
    (root / "portbench/limits/tm1.flat.json").write_text(
        json.dumps({"widest_gap": {"limit": 0.5}}))
    (root / "portbench/metrics").mkdir()
    (root / "portbench/metrics/batches_done.py").write_text(
        "def read(ctx):\n    return len(ctx.records)\n")
    s["configs"].append(dict(s["configs"][0], name="tm1",
                             file="portbench/configs/tm1.json"))
    s["workloads"].append({"name": "tm1.flat", "config": "tm1",
                           "traffic": "flat-24", "chips": 1, "why": "t"})
    s["end_to_end"].append({"name": "batches_done", "unit": "batches",
                            "better": "higher", "bound": 0.1,
                            "source": "host_clock",
                            "workloads": ["tm1.flat"]})
    (root / "BENCHMARK.json").write_text(json.dumps(s))
    line = run_cell(root, "tm1.flat", 9, 0.3, False, "cpu",
                    time.perf_counter())
    assert line["correct"]
    assert set(line["metrics"]) == {"batches_done", "setup_s"}
    assert line["metrics"]["batches_done"]["value"] >= 1


def test_a_per_layer_metric_names_its_workloads():
    b = Bench(REPO)
    cell = b.spec["workloads"][0]["name"]
    b.spec["end_to_end"].append({"name": "e", "unit": "s",
                                 "better": "lower", "bound": 0.1,
                                 "source": "host_clock"})
    assert b.metrics(cell, "end_to_end")[-1]["name"] == "e"
    b.spec["per_layer"].append({"name": "x", "unit": "%", "better": "higher",
                                "source": "device_trace", "layer": "device",
                                "moves": "prefill_tokens_per_s"})
    with pytest.raises(ValueError, match="'x' names no workloads"):
        b.metrics(cell, "per_layer")


def test_benchmark_json_keeps_to_the_contract():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert s["paths"] == ["portbench"] and 1 <= s["run_seconds"] <= 51
    names = [c["name"] for c in s["configs"]]
    cells = [w["name"] for w in s["workloads"]]
    metrics = [m["name"] for m in s["end_to_end"] + s["per_layer"]]
    for n in names + cells + metrics:
        assert NAME.match(n), n
    assert len(set(names)) == len(names) and len(set(cells)) == len(cells)
    assert len(set(metrics)) == len(metrics)
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        f = json.loads((REPO / c["file"]).read_text())
        assert f["reduced"] == c["reduced"] and f["source"] == c["source"]
        assert any(w["config"] == c["name"] for w in s["workloads"])
    pairs = {(w["config"], w["traffic"]) for w in s["workloads"]}
    assert len(pairs) == len(cells)
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        e2e = Bench(REPO).metrics(w["name"], "end_to_end")
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert Bench(REPO).metrics(w["name"], "per_layer")
    e2e = {m["name"] for m in s["end_to_end"]}
    for m in s["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= set(cells)
    layers = set()
    for m in s["per_layer"]:
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert set(m["workloads"]) <= set(cells)
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        layers.add(m["layer"])
    perf = (REPO / "PERF.md").read_text()
    for layer in layers:
        assert f"**{layer}**" in perf, layer


@pytest.mark.parametrize("path", sorted((PB / "traffic").glob("*.json")),
                         ids=lambda p: p.stem)
def test_traffic_is_data(path):
    t = json.loads(path.read_text())
    assert {"entry", "batch", "lengths", "generated", "check", "source",
            "why"} <= set(t)
