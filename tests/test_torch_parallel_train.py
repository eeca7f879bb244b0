"""``train()`` across ranks: the port's CLI as 2 gloo ranks on the CPU
(torchrun's environment, ``--mesh.data_parallel 2``) against one process
over the same local fixture, and checkpoints that cross world sizes.

4 recordings × 4 s (two 2 s cues each), global batch 4, 2 s segments: each
recording batch is K=2 segments; 6 steps are 3 epochs.  Each data rank
reads its own files (i ≡ d mod 2) and owns the global batch's rows d::2, so
the global batch, and its masked-mean loss, is the one process's.  The
model computes in float64 (the JAX package's multi-process test, in float32,
holds the sequences to rtol 2e-4; here the one-device step's 1e-9 of
tests/test_torch_train_step.py).

The resumes stop at step 3, after the first segment of the second recording
batch, so they re-enter mid-batch with the checkpointed global-B carry: a
run saved on 2 ranks resumes on 1, and one saved on 1 resumes on 2, each
giving the uninterrupted run's last three losses.  The same holds for an
xLSTM whose 2 ranks are tensor parallel (dp=1 × mp=2).
"""

import ast
import json
import os

import numpy as np
import pytest
import torch

from statecatcher_tpu_torch.config import Config
from statecatcher_tpu_torch.data.audio import write_wav_bytes
from statecatcher_tpu_torch.train.loop import train
from test_torch_cuda import single_torch_thread  # noqa: F401
from torch_ranks import rank_budget, run_ranks  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_torch_thread")

RTOL = 1e-9
OVERRIDES = ["--model.encoder", "lucyrnn", "--model.hidden_size", "16", "--model.num_layers", "2",
             "--model.dtype", "float64", "--model.param_dtype", "float64",
             "--data.source", "local", "--data.batch_samplerate", "8000",
             "--data.batch_size", "4", "--data.target_duration", "2.0", "--data.num_workers", "1",
             "--train.log_every_n", "1000", "--train.epochs", "100",
             "--train.segments_per_dispatch", "2"]


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(42)
    words = ["hello", "world", "testing", "audio", "stream", "state"]
    for i in range(4):
        x = rng.uniform(-0.3, 0.3, size=4 * 8000).astype(np.float32)
        (d / f"rec{i}.wav").write_bytes(write_wav_bytes(x, 8000))
        lines = ["WEBVTT", ""]
        for j in range(2):
            lines += [f"00:00:{2 * j:06.3f} --> 00:00:{2 * j + 2:06.3f}",
                      " ".join(rng.choice(words, 3)), ""]
        (d / f"rec{i}.vtt").write_text("\n".join(lines))
    return str(d)


# the xLSTM, tensor parallel over 2 ranks: a head and 20 FFN columns a rank
XLSTM = OVERRIDES + ["--model.encoder", "xlstm", "--model.xlstm.embedding_dim", "16",
                     "--model.xlstm.num_heads", "2", "--model.xlstm.num_blocks", "2",
                     "--model.xlstm.chunk_size", "16", "--model.xlstm.ffn_proj_factor", "2.5"]
XLSTM_TP = ["--mesh.data_parallel", "1", "--mesh.model_parallel", "2"]


def _one_process(data, model_dir, steps, resume=None, overrides=OVERRIDES):
    ov = overrides + ["--data.local_dir", data, "--train.model_dir", str(model_dir),
                      "--train.steps", str(steps)]
    if resume:
        ov += ["--train.resume_from", resume]
    return train(Config().apply_overrides(ov), device="cpu")


def _two_ranks(budget, data, model_dir, steps, resume=None, overrides=OVERRIDES,
               mesh=("--mesh.data_parallel", "2")):
    """The CLI on 2 ranks; both ranks' summaries, which must agree."""
    argv = ["--device", "cpu", "--backend", "gloo", *overrides, *mesh,
            "--data.local_dir", data, "--train.model_dir", str(model_dir),
            "--train.steps", str(steps)] + (["--train.resume_from", resume] if resume else [])
    outs = run_ranks(2, argv, budget, module="statecatcher_tpu_torch.cli")
    sums = [ast.literal_eval([ln for ln in o.splitlines() if ln.startswith("{")][-1])
            for o in outs]
    assert sums[0]["loss_history"] == sums[1]["loss_history"]
    assert sums[0]["run_dir"] == sums[1]["run_dir"]           # one shared run directory
    return sums[0]


def test_two_ranks_train_as_one_process(fixture_dir, tmp_path, rank_budget):
    base = _one_process(fixture_dir, tmp_path / "one", 6)
    got = _two_ranks(rank_budget, fixture_dir, tmp_path / "two", 6)
    assert got["global_step"] == 6 and len(base["loss_history"]) == 6
    np.testing.assert_allclose(got["loss_history"], base["loss_history"], rtol=RTOL)
    # rank 0 alone wrote the run's files; the checkpoint holds the global batch's carry
    run = got["run_dir"]
    assert os.path.exists(os.path.join(run, "tokenizer.json"))
    assert os.path.exists(os.path.join(run, "train.rank1.log"))
    blob = torch.load(os.path.join(run, "ckpt", "6", "session.pt"), weights_only=True)
    assert blob["carry"]["h"].shape[0] == 4


def test_checkpoints_cross_world_sizes(fixture_dir, tmp_path, rank_budget):
    full = _one_process(fixture_dir, tmp_path / "full", 6)["loss_history"]

    part2 = _two_ranks(rank_budget, fixture_dir, tmp_path / "part2", 3)
    meta = json.load(open(os.path.join(part2["run_dir"], "ckpt", "3", "meta.json")))
    assert meta["cursor"] == {"batches_done": 1, "seg_idx": 1}      # mid recording batch
    on_one = _one_process(fixture_dir, tmp_path / "res1", 6, resume=part2["run_dir"])
    np.testing.assert_allclose(part2["loss_history"], full[:3], rtol=RTOL)
    np.testing.assert_allclose(on_one["loss_history"], full[3:], rtol=RTOL)

    part1 = _one_process(fixture_dir, tmp_path / "part1", 3)
    on_two = _two_ranks(rank_budget, fixture_dir, tmp_path / "res2", 6, resume=part1["run_dir"])
    assert on_two["global_step"] == 6
    np.testing.assert_allclose(on_two["loss_history"], full[3:], rtol=RTOL)


def test_xlstm_checkpoints_cross_tensor_parallel_meshes(fixture_dir, tmp_path, rank_budget):
    """An xLSTM run saved under dp=1 × mp=2 (the sharded q, k, v, FFN gate and
    up and their Adam moments gathered whole) resumes in one process, and one
    saved by one process resumes under mp=2, each with the uninterrupted
    run's next losses."""
    full = _one_process(fixture_dir, tmp_path / "full", 4, overrides=XLSTM)["loss_history"]
    part2 = _two_ranks(rank_budget, fixture_dir, tmp_path / "part2", 3, overrides=XLSTM,
                       mesh=XLSTM_TP)
    log = open(os.path.join(part2["run_dir"], "train.log")).read()
    assert "mesh 1x2 (tensor parallel model axis)" in log
    on_one = _one_process(fixture_dir, tmp_path / "res1", 4, resume=part2["run_dir"],
                          overrides=XLSTM)
    np.testing.assert_allclose(part2["loss_history"], full[:3], rtol=RTOL)
    np.testing.assert_allclose(on_one["loss_history"], full[3:], rtol=RTOL)

    part1 = _one_process(fixture_dir, tmp_path / "part1", 3, overrides=XLSTM)
    on_two = _two_ranks(rank_budget, fixture_dir, tmp_path / "res2", 4, resume=part1["run_dir"],
                        overrides=XLSTM, mesh=XLSTM_TP)
    assert on_two["global_step"] == 4
    np.testing.assert_allclose(on_two["loss_history"], full[3:], rtol=RTOL)
