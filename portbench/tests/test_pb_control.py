"""The control, at a size a CPU test run can hold: the plain reference
computed with fp8 (e4m3) weights and matmul inputs in the program's
place must come out not correct under each cell's limits, while the
program's own served tokens, checked the same way, come out correct.
The cells here are the small ones of `_tiny` grown to 8 layers of width
512, with their limits."""
import pytest

from portbench.harness import Bench, CellRun
from portbench.tests._tiny import CELLS, DECODE, make_root

SIZES = {"mixtral-8x22b-8l": dict(n_layers=8, d_model=512, n_heads=8,
                                  n_kv_heads=2, head_dim=64, d_ff=1024,
                                  vocab_size=8192, sliding_window=4096,
                                  n_experts=8)}
PREFILL = dict(impl="chunked", batch=4, lengths=[64, 128, 256],
               trace_batches=3,
               check={"batches": {"64": 4, "128": 2, "256": 1}})
DECODE = dict(DECODE, batch=8, lengths=[16], generated=32,
              check={"requests": 8})


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("mid"), SIZES, PREFILL, DECODE)


def over(got: dict, limits: dict, prefix: str = "") -> bool:
    return any(got[prefix + k] > v["limit"] for k, v in limits.items())


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [1, 2])
def test_the_control_fails_and_the_program_passes(root, cell, seed):
    run = CellRun(Bench(root), cell, seed, "cpu")
    run.setup()
    # a fixed number of batches whatever the CPU's speed (four of each
    # length): the sample the check draws from is the same on every
    # machine
    n = 12 if cell.endswith("prefill") else 1
    run.records = [run.entry.issue(i) for i in range(n)]
    got = run.check(control=True)
    assert over(got, run.limits, "control_"), got
    assert not over(got, run.limits), got
