"""The RNN-T training entry points of the PyTorch port on the CPU: the CLI
(``--train.mode rnnt``) through ``train.loop.train`` on a generated local
fixture.  The arithmetic is held against the JAX package by
tests/test_torch_rnnt_train_step.py; here the loop, the tokenizer and the
checkpoint run in RNN-T mode end to end."""

import ast
import os

import numpy as np
import pytest
import torch

from statecatcher_tpu_torch.cli import main
from test_torch_cuda import single_torch_thread  # noqa: F401
from test_torch_train_loop import tiny_overrides, write_fixture

pytestmark = pytest.mark.usefixtures("single_torch_thread")


def test_cli_trains_rnnt_on_cpu(tmp_path, capsys):
    """``python -m statecatcher_tpu_torch.cli --train.mode rnnt`` on a local
    fixture: four segments train, the losses are finite, and the checkpoint
    holds the joiner."""
    data = write_fixture(str(tmp_path / "data"), 5)
    argv = tiny_overrides(data, str(tmp_path / "run"), "--train.steps", "4", "--train.mode", "rnnt",
                          "--train.rnnt_band", "0")
    assert main(["--device", "cpu"] + argv) == 0
    summary = ast.literal_eval(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["global_step"] == 4 and np.isfinite(summary["loss_history"]).all()
    (run,) = os.listdir(tmp_path / "run")
    session = torch.load(tmp_path / "run" / run / "ckpt" / "4" / "session.pt", weights_only=True)
    assert "joiner.join_kernel" in session["state"]["params"]
