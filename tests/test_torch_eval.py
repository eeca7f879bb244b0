"""Evaluation of the PyTorch port (statecatcher_tpu_torch/eval.py) against the
JAX package's ``evaluate`` on the same weights, data and tokenizer.

The fixture's cues run back to back across the 2 s segments, so the chunker
duplicates a boundary cue into the next segment: the reference dedup, the
CTC decoders' forced-blank frames and the RNN-T decoders' trimmed lengths
all run.  Both sides evaluate float32 models (as eval runs) on the same
features (the port is given the JAX frontend's, which agrees with its own to
f32 round-off, tests/test_torch_frontend.py), with seeded random weights
(``_random_weights``) under which the decodes vary from frame to frame.  Held: the same refs, hyps, WER and CER, for the LSTM
(greedy, beam), a LucyRNN in CTC mode (greedy, beam) and in RNN-T mode
(rnnt-greedy, rnnt-beam).  ``main`` runs end to end on a run directory that
the port's CLI wrote.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from statecatcher_tpu import eval as jeval
from statecatcher_tpu.config import Config as JConfig
from statecatcher_tpu.frontend import compute_features as j_compute_features
from statecatcher_tpu.train.loop import build_tokenizer as j_build_tokenizer
from statecatcher_tpu_torch import eval as teval
from statecatcher_tpu_torch.cli import main as cli_main
from statecatcher_tpu_torch.config import Config
from statecatcher_tpu_torch.convert import flax_to_torch, torch_to_flax
from statecatcher_tpu_torch.data.audio import write_wav_bytes
from statecatcher_tpu_torch.data.chunking import group_cues_into_chunks, segment_meta
from statecatcher_tpu_torch.models.speech import build_speech_model
from statecatcher_tpu_torch.testing import randomize_, synth_audio
from statecatcher_tpu_torch.train.loop import build_tokenizer
from test_torch_cuda import single_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_torch_thread")

WORDS = ["alpha", "bravo", "charlie", "delta", "echo", "foxtrot", "golf", "hotel"]
CUE = 1.24                                   # s; back to back across 2 s segments


def write_fixture(d, seed=0, n=4, seconds=5.0, sr=8000):
    rng = np.random.default_rng(seed)
    os.makedirs(d, exist_ok=True)
    for i in range(n):
        x = synth_audio(rng, 1, int(seconds * sr))[0]
        with open(os.path.join(d, f"rec{i}.wav"), "wb") as f:
            f.write(write_wav_bytes(x, sr))
        lines, t = ["WEBVTT", ""], 0.0
        while t + CUE <= seconds:
            stamp = lambda s: f"00:00:{s:06.3f}"
            lines += [f"{stamp(t)} --> {stamp(t + CUE)}", " ".join(rng.choice(WORDS, 3)), ""]
            t += CUE
        with open(os.path.join(d, f"rec{i}.vtt"), "w") as f:
            f.write("\n".join(lines))
    return d


def _overrides(data, encoder, mode):
    return ["--model.encoder", encoder, "--model.hidden_size", "16", "--model.num_layers", "2",
            "--model.rnnt_pred_emb_dim", "8", "--model.rnnt_joiner_dim", "8",
            "--train.mode", mode, "--data.source", "local", "--data.local_dir", data,
            "--data.batch_samplerate", "8000", "--data.batch_size", "2",
            "--data.target_duration", "2.0", "--data.num_workers", "2"]


def test_fixture_duplicates_boundary_cues():
    cues = [(k * CUE, (k + 1) * CUE, "x") for k in range(4)]
    metas = segment_meta(group_cues_into_chunks(cues, 2.0), 2.0)
    assert metas[0]["overlap_start"] is not None and metas[1]["dup_first_text"] == "x"


def _random_weights(model, cfg, seed=1):
    """Seeded weights whose decodes vary from frame to frame.  The LSTM: every
    flax kernel N(0, 2.25/fan_in), vectors 0.3·N(0, 1) added (randomize_'s
    smaller matrices leave its outputs nearly constant, one label winning
    every frame); the LucyRNN: ``randomize_`` (its gate-bias offsets keep the
    cell's f32 round-off small), the join kernel widened ×8."""
    if cfg.model.encoder == "lstm":
        rng = np.random.default_rng(seed)
        tree = torch_to_flax(model.state_dict(), cfg.model)
        draw = lambda x: (rng.standard_normal(x.shape) * 1.5 / np.sqrt(x.shape[0]) if x.ndim == 2
                          else x + 0.3 * rng.standard_normal(x.shape)).astype(np.float32)
        model.load_state_dict(flax_to_torch(jax.tree_util.tree_map(draw, tree), cfg.model))
        return
    randomize_(model, seed)
    if getattr(model, "joiner", None) is not None:
        with torch.no_grad():
            model.joiner.join_kernel.mul_(8.0)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return write_fixture(str(tmp_path_factory.mktemp("eval") / "data"))


@pytest.mark.parametrize("encoder,mode,decoders", [
    ("lstm", "ctc", ("greedy", "beam")),
    ("lucyrnn", "ctc", ("greedy", "beam")),
    ("lucyrnn", "rnnt", ("rnnt-greedy", "rnnt-beam")),
])
def test_evaluate_matches_jax(data, encoder, mode, decoders, monkeypatch):
    ov = _overrides(data, encoder, mode)
    cfg, jcfg = Config().apply_overrides(ov), JConfig().apply_overrides(ov)
    tok, jtok = build_tokenizer(cfg), j_build_tokenizer(jcfg)
    assert tok.to_dict() == jtok.to_dict()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, vocab_size=tok.vocab_size))
    jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(jcfg.model,
                                                               vocab_size=tok.vocab_size))
    model = build_speech_model(cfg.model, 80, mode, device="cpu",
                               generator=torch.Generator().manual_seed(0))
    _random_weights(model, cfg)
    params = model.state_dict()
    jparams = jax.tree_util.tree_map(jnp.asarray, torch_to_flax(params, cfg.model))
    monkeypatch.setattr(teval, "compute_features", lambda audio, fe: torch.from_numpy(
        np.array(j_compute_features(jnp.asarray(audio.numpy()), fe))))
    for decoder in decoders:
        want = jeval.evaluate(jcfg, jparams, jtok, max_batches=2, decoder=decoder, beam=4)
        got = teval.evaluate(cfg, params, tok, max_batches=2, decoder=decoder, beam=4,
                             device="cpu")
        assert got.num_utterances == want.num_utterances == 4
        assert got.num_segments == want.num_segments
        assert got.refs == want.refs
        assert got.hyps == want.hyps, decoder
        assert (got.wer, got.cer) == (want.wer, want.cer)
        assert all(got.hyps) and len(set("".join(got.hyps))) > 3     # not one label throughout
    # the boundary cue was duplicated and dropped once from the references
    assert all(len(r.split()) == 12 for r in got.refs)


def test_main_end_to_end_on_a_cli_run(tmp_path, capsys):
    data = write_fixture(str(tmp_path / "data"), seed=3)
    ov = _overrides(data, "lucyrnn", "ctc")
    assert cli_main(["--device", "cpu", *ov, "--train.steps", "2",
                     "--train.segments_per_dispatch", "1",
                     "--train.model_dir", str(tmp_path / "runs")]) == 0
    run_dir = eval(capsys.readouterr().out.strip().splitlines()[-1])["run_dir"]
    assert teval.main(["--ckpt", run_dir, "--decoder", "beam", "--max-batches", "1",
                       "--device", "cpu", *ov]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    cfg, tok, params = teval.load_run(run_dir, Config().apply_overrides(ov), "cpu")
    res = teval.evaluate(cfg, params, tok, max_batches=1, decoder="beam", device="cpu")
    assert line == (f"WER: {res.wer:.4f}  CER: {res.cer:.4f}  "
                    f"({res.num_utterances} utterances, {res.num_segments} segments)")
    assert teval.main(["--decoder", "greedy"]) == 1                  # --ckpt is required
