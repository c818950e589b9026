"""What the benchmark loads: no module whose top-level name is jax,
jaxlib, flax or repro (names compared whole: the port's package begins
with `repro`), a reference that imports nothing of the program, and a
run that prints no result without a card or without the program."""
import ast
import json
import shutil
import subprocess
import sys

import pytest

from portbench.harness import FORBIDDEN
from portbench.tests._tiny import PB, REPO

LOAD_ALL = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
import runpy
runpy.run_path({run!r}, run_name="portbench_run")
from portbench.harness import Bench, model_config
import portbench.calibrate, portbench.trace, portbench.weights
b = Bench({root!r})
for w in b.spec["workloads"]:
    b.module("entries", b.traffic(w["traffic"])["entry"])
    family = model_config(b.config(w["config"])).family
    for kind in ("reference", "params", "arithmetic"):
        b.module(kind, family)
for kind in ("entries", "reference", "params", "arithmetic", "metrics"):
    for p in sorted((b.root / "portbench" / kind).glob("[!_]*.py")):
        b.module(kind, p.stem)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_nothing_the_run_loads_is_jax_or_the_jax_package():
    code = LOAD_ALL.format(root=str(REPO), src=str(REPO / "src"),
                           run=str(PB / "run.py"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in names and "torch" in names
    assert not names & set(FORBIDDEN)


def imported(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted((PB / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = {n.split(".")[0] for n in imported(path)}
    assert tops <= {"torch", "math", "__future__"}, tops


def test_no_harness_file_reads_the_jax_packages_benchmarks():
    for path in PB.rglob("*.py"):
        if "tests" in path.relative_to(PB).parts:
            continue
        text = path.read_text()
        assert "benchmarks/" not in text and "BENCH_" not in text, path


def run(cwd, *extra):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "mixtral-8x22b.prefill-azure", "--seed", "2147483659", "--seconds", "1",
         "--trace", "0", *extra], capture_output=True, text=True,
        timeout=300, cwd=cwd, env={"PATH": "/usr/bin:/bin",
                                   "CUDA_VISIBLE_DEVICES": ""})


def test_a_run_without_a_card_prints_no_result():
    out = run(REPO)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA card" in out.stderr


def test_a_run_with_the_benchmark_alone_prints_no_result(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(PB, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
