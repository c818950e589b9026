"""Set-up shared by the two test trees, `tests/` and `portbench/tests/`.

The benchmark's harness refuses a run from a process that holds JAX or
the JAX package (`portbench.harness.forbidden_modules`): the machine it
runs on has neither. One pytest process runs both trees, and the parity
tests of `tests/` import both, so each benchmark test runs with those
modules set aside from `sys.modules` and gets them back after. Meanwhile
an import of them fails with ImportError, so benchmark code that reaches
for JAX fails its test (as the harness would refuse it in a process of
its own) rather than loading jaxlib a second time. A benchmark test
also runs torch on one CPU thread, as `portbench/run.py` does: the
tier-1 command runs six workers at once, and with a thread a core in
each, one such test ran ten times as long as alone.
"""
import sys
from pathlib import Path

import pytest

from portbench.harness import FORBIDDEN

BENCH_TESTS = Path(__file__).resolve().parent / "portbench"


class _Refused:
    """A meta-path finder that refuses the modules set aside."""

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ImportError(f"{name} is set aside while a benchmark "
                              f"test runs: the benchmark may not use it")
        return None


@pytest.fixture(autouse=True)
def _benchmark_test_process(request):
    if BENCH_TESTS not in Path(request.node.path).resolve().parents:
        yield
        return

    def held():
        return {k: m for k, m in sys.modules.items()
                if k.split(".")[0] in FORBIDDEN}
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    aside = held()
    for k in aside:
        del sys.modules[k]
    refused = _Refused()
    sys.meta_path.insert(0, refused)
    try:
        yield
    finally:
        sys.meta_path.remove(refused)
        torch.set_num_threads(threads)
        for k in held():
            del sys.modules[k]
        sys.modules.update(aside)
