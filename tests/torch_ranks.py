"""Helpers of the port's multi-rank CPU tests: run
``python -m statecatcher_tpu_torch.parallel.dryrun`` (or the CLI) as N gloo
ranks with torchrun's environment, one intra-op thread each, and read what
each rank wrote.  A test's launches share a wall limit of TEST_LIMIT_S from
the test's start; a launch still running then has its ranks killed."""

import os
import time

import pytest
import torch

from statecatcher_tpu_torch.parallel.dryrun import launch_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEST_LIMIT_S = 90.0
ONE_THREAD = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


class RankBudget:
    """The wall time a test has left for its rank launches."""

    def __init__(self, seconds: float = TEST_LIMIT_S):
        self.end = time.monotonic() + seconds

    def left(self) -> float:
        left = self.end - time.monotonic()
        assert left > 0, f"the test's {TEST_LIMIT_S:g} s for its ranks ran out"
        return left


@pytest.fixture
def rank_budget():
    return RankBudget()


def run_ranks(world: int, argv: list, budget: RankBudget,
              module: str = "statecatcher_tpu_torch.parallel.dryrun") -> list:
    """Launch ``world`` gloo ranks of ``module`` on the CPU; every rank must
    exit 0 within the test's budget.  Returns each rank's output."""
    res = launch_ranks(world, argv, budget.left(), module=module, env=ONE_THREAD, cwd=REPO)
    for r, (rc, out) in enumerate(res):
        assert rc == 0, f"rank {r} exited {rc}:\n{out[-4000:]}"
    return [out for _, out in res]


def dryrun(tmp_path, budget: RankBudget, world: int, inputs: dict) -> list:
    """The dryrun over ``world`` ranks on ``inputs``; each rank's result."""
    src, out = tmp_path / "dryrun.in.pt", tmp_path / "dryrun.out"
    torch.save(inputs, src)
    run_ranks(world, ["--inputs", str(src), "--out", str(out), "--device", "cpu",
                      "--backend", "gloo"], budget)
    return [torch.load(f"{out}.rank{r}.pt", weights_only=False) for r in range(world)]
