"""The LSTM encoder of the PyTorch port (statecatcher_tpu_torch/models/lstm.py,
the LSTM branch of models/asr.py) against the JAX package on the same
weights (``convert.flax_to_torch``), and its training, CLI and metrics sink.

  * ``LSTMEncoder`` unmasked and masked (a row masked throughout, a mask
    with holes), and ``ASRModel``/``SpeechModel`` logits and carry over
    three carried segments in CTC and RNN-T mode, in float64 on both sides:
    rtol 1e-10, atol 1e-12 (the same operations; only BLAS summation order
    differs).
  * The carry across two segments equals one long segment (float64, 1e-12).
  * bfloat16: the port's logits and carry within 4 bf16 steps of JAX's
    (a step is 2⁻⁸ of the tensor's largest value; XLA keeps a fusion's
    intermediates in f32, the port rounds each op), and no further from the
    float64 run than JAX's, plus one step.
  * The LSTM-CTC train step in lockstep with JAX over two groups of two
    updates, with ``test_torch_train_step.py``'s harness and tolerances.
  * The CLI with the config's default encoder (no ``--model.encoder``)
    trains on a fixture and resumes.
  * The Aim sink through a stub ``aim`` module (the package is not
    installed).
"""

import json
import logging
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from statecatcher_tpu.config import Config as JConfig
from statecatcher_tpu.models.asr import build_model as j_build_model
from statecatcher_tpu.models.lstm import LSTMEncoder as JLSTMEncoder
from statecatcher_tpu.models.speech import build_speech_model as j_build_speech
from statecatcher_tpu_torch import metrics
from statecatcher_tpu_torch.cli import main as cli_main
from statecatcher_tpu_torch.config import Config
from statecatcher_tpu_torch.convert import flax_to_torch, torch_to_flax
from statecatcher_tpu_torch.models.asr import build_model, init_carry
from statecatcher_tpu_torch.models.lstm import LSTMEncoder
from statecatcher_tpu_torch.models.speech import build_speech_model
from test_torch_cuda import single_torch_thread  # noqa: F401
from test_torch_train_step import (
    ATOL,
    RTOL,
    _close,
    _groups,
    _jax_features,
    _run_jax,
    _run_torch,
)
from test_torch_train_loop import write_fixture

pytestmark = pytest.mark.usefixtures("single_torch_thread")

B, T, F, H, L, V = 3, 14, 6, 8, 2, 11


def _draw(params, seed):
    """Seeded random weights in place of every leaf."""
    rng = np.random.default_rng(seed)

    def draw(x):
        x = np.asarray(x)
        if x.ndim == 2:
            return rng.standard_normal(x.shape) * (1.5 / np.sqrt(x.shape[0]))
        return x + 0.3 * rng.standard_normal(x.shape)

    return jax.tree_util.tree_map(draw, jax.device_get(params))


def _masks():
    holes = np.ones((B, T), bool)
    holes[0, 3:6] = False                  # not a prefix
    holes[0, 9] = False
    holes[1] = False                        # a row of length 0
    holes[2, 10:] = False
    return {"none": None, "holes": holes}


@pytest.mark.parametrize("mask_kind", ["none", "holes"])
def test_lstm_encoder_matches_jax(mask_kind):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, T, F))
    h0, c0 = (rng.standard_normal((B, L, H)) * 0.5 for _ in range(2))
    mask = _masks()[mask_kind]
    with jax.enable_x64(True):
        jenc = JLSTMEncoder(input_dim=F, hidden_size=H, num_layers=L, dtype=jnp.float64,
                            param_dtype=jnp.float64)
        params = _draw(jenc.init(jax.random.PRNGKey(0), jnp.asarray(x)), 1)
        jy, jst = jenc.apply(params, jnp.asarray(x), {"h": jnp.asarray(h0), "c": jnp.asarray(c0)},
                             None if mask is None else jnp.asarray(mask))
        jy, jst = np.asarray(jy), {k: np.asarray(v) for k, v in jst.items()}
    enc = LSTMEncoder(F, H, L, dtype=torch.float64, param_dtype=torch.float64,
                      generator=torch.Generator().manual_seed(0))
    enc.load_state_dict({f"layer{l}.{n}": torch.from_numpy(np.asarray(params["params"][
        f"layer{l}"][n])) for l in range(L) for n in ("w_ih", "w_hh", "b_ih", "b_hh")})
    with torch.inference_mode():
        y, st = enc(torch.from_numpy(x), {"h": torch.from_numpy(h0), "c": torch.from_numpy(c0)},
                    None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(y.numpy(), jy, rtol=1e-10, atol=1e-12)
    for k in ("h", "c"):
        np.testing.assert_allclose(st[k].numpy(), jst[k], rtol=1e-10, atol=1e-12)
    if mask is not None:
        # a row masked throughout outputs zeros and keeps the carry it came in with
        assert (y[1] == 0).all()
        np.testing.assert_array_equal(st["h"][1].numpy(), h0[1])
        np.testing.assert_array_equal(st["c"][1].numpy(), c0[1])


def test_lstm_carry_across_segments_equals_one_segment():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((B, 2 * T, F)))
    enc = LSTMEncoder(F, H, L, dtype=torch.float64, param_dtype=torch.float64,
                      generator=torch.Generator().manual_seed(3))
    with torch.inference_mode():
        y, st = enc(x)
        y1, st1 = enc(x[:, :T])
        y2, st2 = enc(x[:, T:], st1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y.numpy(), rtol=1e-12, atol=1e-14)
    for k in ("h", "c"):
        np.testing.assert_allclose(st2[k].numpy(), st[k].numpy(), rtol=1e-12, atol=1e-14)


def _overrides(dtype="float64", proj=-1, stack=1):
    return ["--model.hidden_size", str(H), "--model.num_layers", str(L),
            "--model.vocab_size", str(V), "--model.input_proj_dim", str(proj),
            "--model.stack_order", str(stack), "--model.dtype", dtype,
            "--model.param_dtype", dtype, "--model.rnnt_pred_emb_dim", "5",
            "--model.rnnt_joiner_dim", "7"]


def _segments(seed, stack):
    rng = np.random.default_rng(seed)
    feats = [rng.standard_normal((B, T, F)) * 2.0 for _ in range(3)]
    Te = T // stack
    mask = np.ones((B, Te), bool)
    mask[1, Te // 2:] = False
    mask[2, 1] = False
    return feats, [None, None, mask]


def _run_both(kind, dtype, proj=-1, stack=1):
    """Three carried segments of features (the last with a frame mask)
    through JAX's and the port's model (``kind``: "asr", "ctc" or "rnnt")
    on the same weights; → [(logits, carry)] of each."""
    ov = _overrides(dtype, proj, stack)
    jcfg, cfg = JConfig().apply_overrides(ov), Config().apply_overrides(ov)
    assert cfg.model.encoder == "lstm"                       # the config's default
    feats, masks = _segments(7, stack)
    jdt = {"float64": jnp.float64, "bfloat16": jnp.bfloat16}[dtype]
    build = build_model if kind == "asr" else (lambda c, f, device: build_speech_model(
        c, f, kind, device=device))
    # the weights: the float64 twin's tree, drawn at random; each side rounds
    # it to its parameter dtype (round to nearest even on both)
    c64 = Config().apply_overrides(_overrides("float64", proj, stack))
    params = _draw(torch_to_flax(build(c64.model, F, device="cpu").state_dict(), c64.model), 4)
    with jax.enable_x64(True):
        jmodel = j_build_model(jcfg.model, F) if kind == "asr" else j_build_speech(
            jcfg.model, F, kind)
        jparams = jax.tree_util.tree_map(lambda p: jnp.asarray(p, jdt), params)
        jcarry, jout = None, []
        for x, m in zip(feats, masks):
            kw = {"method": "encode"} if kind == "rnnt" else {}
            logits, jcarry = jmodel.apply(jparams, jnp.asarray(x, jdt), jcarry,
                                          None if m is None else jnp.asarray(m), **kw)
            jout.append((np.asarray(logits, np.float64),
                         {k: np.asarray(v, np.float64) for k, v in jcarry.items()}))
    model = build(cfg.model, F, device="cpu")
    model.load_state_dict(flax_to_torch(params, cfg.model))
    tdt = {"float64": torch.float64, "bfloat16": torch.bfloat16}[dtype]
    carry, out = None, []
    with torch.inference_mode():
        for x, m in zip(feats, masks):
            logits, carry = model(torch.from_numpy(x).to(tdt), carry,
                                  None if m is None else torch.from_numpy(m))
            out.append((logits.double().numpy(), {k: v.double().numpy() for k, v in carry.items()}))
    return jout, out, (jmodel, jparams, model)


@pytest.mark.parametrize("kind,proj,stack", [("asr", -1, 1), ("asr", 5, 2), ("ctc", -1, 1),
                                             ("rnnt", -1, 1)])
def test_lstm_asr_model_matches_jax(kind, proj, stack):
    jout, out, (jmodel, params, model) = _run_both(kind, "float64", proj, stack)
    for (jl, jc), (tl, tc) in zip(jout, out):
        assert tl.shape == jl.shape
        np.testing.assert_allclose(tl, jl, rtol=1e-10, atol=1e-12)
        for k in ("h", "c"):
            np.testing.assert_allclose(tc[k], jc[k], rtol=1e-10, atol=1e-12)
    if kind == "rnnt":
        # the joiner's decode tables on top of the LSTM's logits
        with jax.enable_x64(True):
            jt = jmodel.apply(params, method="rnnt_decode_tables")
        with torch.inference_mode():
            tt = model.rnnt_decode_tables()
        for a, b in zip(tt, jt):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-12, atol=1e-14)


def test_lstm_bf16_within_bf16_steps():
    """bfloat16 on both sides: XLA keeps a fusion's intermediates in f32,
    the port rounds every op to bf16, so single values differ by several
    ulps; held per tensor in steps of its largest value (2⁻⁸·max|x|): the
    port within 4 steps of JAX, and no further from the float64 run than
    JAX is, plus one step."""
    jout, out, _ = _run_both("asr", "bfloat16")
    _, ref, _ = _run_both("asr", "float64")
    for (jl, jc), (tl, tc), (rl, rc) in zip(jout, out, ref):
        for a, b, r in [(tl, jl, rl)] + [(tc[k], jc[k], rc[k]) for k in ("h", "c")]:
            step = 2.0 ** -8 * np.abs(r).max()
            assert np.abs(a - b).max() <= 4 * step
            assert np.abs(a - r).max() <= np.abs(b - r).max() + step


def test_lstm_carry_layout_and_flax_bridge():
    cfg = Config().apply_overrides(_overrides("float32"))
    c = init_carry(cfg.model, 4, device="cpu")
    assert set(c) == {"h", "c"} and c["h"].shape == (4, L, H)
    for mode in ("ctc", "rnnt"):
        model = build_speech_model(cfg.model, F, mode, device="cpu")
        sd = model.state_dict()
        tree = torch_to_flax(sd, cfg.model)["params"]
        # the flax layout: w_ih (Din, 4H), no transpose on the way
        assert tree["asr"]["encoder"]["layer0"]["w_ih"].shape == (F, 4 * H)
        assert tree["asr"]["classifier"]["kernel"].shape == (H, V)
        back = flax_to_torch({"params": tree}, cfg.model)
        assert sorted(back) == sorted(sd)
        for k in sd:
            assert torch.equal(back[k], sd[k]), k


CASES = ["adam", "row_invalid", "int16_audio"]


@pytest.mark.parametrize("case", CASES)
def test_lstm_ctc_train_step_matches_jax_in_lockstep(case, monkeypatch):
    """Two groups of two segments: loss, grad norm, greedy output per
    segment, every parameter and the carry after each group (the tolerances
    of tests/test_torch_train_step.py)."""
    import statecatcher_tpu_torch.train.step as step_module

    ov = ["--model.hidden_size", "16", "--model.num_layers", "2", "--model.vocab_size", "24",
          "--model.dtype", "float64", "--model.param_dtype", "float64",
          "--train.optim.lr", "3e-3"]
    cfg, jcfg = Config().apply_overrides(ov), JConfig().apply_overrides(ov)
    assert cfg.model.encoder == "lstm"
    model = build_speech_model(cfg.model, 80, "ctc", device="cpu",
                               generator=torch.Generator().manual_seed(0))
    params = torch_to_flax(model.state_dict(), cfg.model)
    groups = _groups(case, seed=len(case))
    want = _run_jax(jcfg, params, groups, monkeypatch)
    monkeypatch.setattr(step_module, "compute_features", _jax_features(jcfg.frontend))
    got = _run_torch(cfg, model, groups)
    for g, ((t_out, t_par, t_car), (j_out, j_par, j_car)) in enumerate(zip(got, want)):
        for k in ("loss", "grad_norm", "per_loss"):
            _close(t_out[k], j_out[k], RTOL[k], 0, f"group {g} {k}")
        np.testing.assert_array_equal(t_out["preds"], j_out["preds"])
        np.testing.assert_array_equal(t_out["keep"], j_out["keep"])
        for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(t_par),
                                     jax.tree_util.tree_leaves_with_path(j_par)):
            _close(a, b, RTOL["params"], ATOL["params"], f"group {g} {jax.tree_util.keystr(path)}")
        for k in ("h", "c"):
            _close(t_car[k], j_car[k], RTOL["carry"], ATOL["carry"], f"group {g} carry {k}")


def test_cli_trains_the_default_encoder_and_resumes(tmp_path, capsys):
    data = write_fixture(str(tmp_path / "data"), seed=5)
    common = ["--device", "cpu", "--model.hidden_size", "16", "--model.num_layers", "2",
              "--data.source", "local", "--data.local_dir", data,
              "--data.batch_samplerate", "8000", "--data.batch_size", "2",
              "--data.target_duration", "2.0", "--data.num_workers", "2",
              "--train.log_every_n", "2", "--train.segments_per_dispatch", "1"]
    assert cli_main(common + ["--train.steps", "2", "--train.model_dir",
                              str(tmp_path / "a")]) == 0
    first = eval(capsys.readouterr().out.strip().splitlines()[-1])   # the printed summary
    cfg = json.load(open(os.path.join(first["run_dir"], "training_config.json")))
    assert cfg["model"]["encoder"] == "lstm"
    assert first["global_step"] == 2 and np.isfinite(first["loss_history"]).all()
    assert cli_main(common + ["--train.steps", "3", "--train.resume_from", first["run_dir"],
                              "--train.model_dir", str(tmp_path / "b")]) == 0
    second = eval(capsys.readouterr().out.strip().splitlines()[-1])
    assert second["global_step"] == 3 and len(second["loss_history"]) == 1


def test_aim_sink_through_a_stub_module(tmp_path, monkeypatch):
    """``make_sinks`` adds the Aim sink when ``aim`` imports, as JAX's does,
    and drops it when it does not.  ``aim`` is not installed: a stub module
    records the calls."""
    calls = []

    class Run(dict):
        def __init__(self, experiment):
            calls.append(("run", experiment))

        def track(self, value, name, step):
            calls.append(("track", value, name, step))

        def __setitem__(self, k, v):
            calls.append(("set", k, v))

        def close(self):
            calls.append(("close",))

    monkeypatch.setitem(sys.modules, "aim", types.SimpleNamespace(Run=Run))
    run_dir = str(tmp_path / "1700000000")
    os.makedirs(run_dir)
    sinks = metrics.make_sinks(logging.getLogger("test"), run_dir)
    assert [type(s).__name__ for s in sinks.sinks] == ["LoggingSink", "JsonlSink", "AimSink"]
    sinks.set_params({"lr": 1e-3})
    sinks.track(0.5, "loss", 3)
    sinks.close()
    assert calls == [("run", "asr_statecatcher_1700000000"), ("set", "hparams", {"lr": 1e-3}),
                     ("track", 0.5, "loss", 3), ("close",)]
    monkeypatch.setitem(sys.modules, "aim", None)          # import aim → ImportError
    sinks = metrics.make_sinks(logging.getLogger("test"), run_dir)
    assert [type(s).__name__ for s in sinks.sinks] == ["LoggingSink", "JsonlSink"]
    sinks.close()


@pytest.mark.parametrize("decoder", ["greedy", "rnnt"])
def test_lstm_streams_as_jax_does(decoder, monkeypatch):
    """The existing streaming decoders take the LSTM as they are: greedy CTC
    and greedy RNN-T against JAX's recognizer, float64 weights on both sides,
    the port on the JAX frontend's features (the frontends agree to f32
    round-off, tests/test_torch_frontend.py)."""
    from statecatcher_tpu.frontend import compute_features as j_compute_features
    from statecatcher_tpu.streaming import StreamingRecognizer as JStreamingRecognizer
    from statecatcher_tpu_torch import streaming as streaming_module
    from statecatcher_tpu_torch.streaming import StreamingRecognizer

    mode = "rnnt" if decoder == "rnnt" else "ctc"
    ov = _overrides("float64")
    cfg, jcfg = Config().apply_overrides(ov), JConfig().apply_overrides(ov)
    model = build_speech_model(cfg.model, 80, mode, device="cpu")
    params = _draw(torch_to_flax(model.state_dict(), cfg.model), 6)
    model.load_state_dict(flax_to_torch(params, cfg.model))
    monkeypatch.setattr(streaming_module, "compute_features", lambda audio, fe: torch.from_numpy(
        np.array(j_compute_features(jnp.asarray(audio.numpy()), fe))))
    audio = np.random.default_rng(8).uniform(-0.5, 0.5, 16000 * 2).astype(np.float32)
    rec = StreamingRecognizer(model, cfg, chunk_frames=16, decoder=decoder, max_out=32,
                              device="cpu")
    with jax.enable_x64(True):
        jrec = JStreamingRecognizer(j_build_speech(jcfg.model, 80, mode), params, jcfg,
                                    chunk_frames=16, decoder=decoder, max_out=32)
        for i in range(0, len(audio), 3000):
            rec.accept_waveform(audio[i:i + 3000])
            jrec.accept_waveform(audio[i:i + 3000])
        rec.finish()
        jrec.finish()
    assert len(jrec.tokens) > 5
    assert rec.tokens == jrec.tokens and rec.committed_tokens == jrec.committed_tokens
