"""The port's speed-of-light model (statecatcher_tpu_torch/roofline.py)
against the JAX package's ``train_step_roofline``, on the CPU, in plain
arithmetic (no model is built).

The FLOPs and bytes follow the JAX module term for term, but for the
product counts where the JAX module contradicts the model both packages
build (ROADMAP.md §3): the xLSTM's ``num_blocks``, the LSTM's recurrent
product, the input projection, the native LucyRNN's products, the RNN-T
joiner's projections and the LucyRNN's tracks.  The parity cases hold
every other term to JAX at relative 1e-12 and add the LSTM's, the native
LucyRNN's and the joiner's terms, computed here by hand; one test per
difference asserts its exact size.  The bound is the H100's, checked by
hand from the data-sheet rates.
"""

import ast
import dataclasses
from pathlib import Path

import pytest

from statecatcher_tpu.config import Config as JConfig
from statecatcher_tpu.roofline import train_step_roofline as j_roofline
from statecatcher_tpu_torch import roofline
from statecatcher_tpu_torch.config import Config
from statecatcher_tpu_torch.roofline import train_step_roofline

ENCODERS = {
    "lstm": ["--model.encoder", "lstm"],
    "lucyrnn": ["--model.encoder", "lucyrnn"],
    "native": ["--model.encoder", "lucyrnn", "--model.lucyrnn.variant", "native"],
    # num_blocks == num_layers: the block count is not a difference here
    "xlstm": ["--model.encoder", "xlstm", "--model.xlstm.num_blocks", "4"],
    "rwkv": ["--model.encoder", "rwkv"],
}
U = 128
FRAMES = 100.0                       # 16 kHz, hop 160: frames an audio-second


def _both(argv, mode="ctc", U=U, feat=80):
    port = train_step_roofline(Config().apply_overrides(argv), feat, U, mode)
    jax_ = j_roofline(JConfig().apply_overrides(argv), feat, U, mode)
    return port, jax_


def _adam_bytes(params, cfg):
    """Adam's 7 f32 accesses a parameter, spread over one segment's audio."""
    return params * 4 * 7 / (cfg.data.batch_size * cfg.data.target_duration)


def _lstm_term(m):
    """The LSTM's h·w_hh: (FLOPs a frame fwd+bwd, parameters)."""
    D, L = m.hidden_size, m.num_layers
    return 3 * 2 * L * D * 4 * D, L * D * 4 * D


def _native_term(m, din0):
    """The native LucyRNN's products and parameters less the JAX module's
    six gate-widths a layer: (FLOPs a frame fwd+bwd, parameters)."""
    D, L = m.hidden_size, m.num_layers
    n = 6 if m.lucyrnn.fused_ops else 5
    model_fwd = (2 * din0 * D + 2 * n * D * D) + (L - 1) * (2 * D * D + 2 * n * D * D)
    jax_fwd = 2 * din0 * 6 * D + 2 * (L - 1) * D * 6 * D
    model_params = (din0 * D + 6 * D * D) + (L - 1) * 7 * D * D
    jax_params = din0 * 6 * D + (L - 1) * 6 * D * D
    return 3 * (model_fwd - jax_fwd), model_params - jax_params


def _joiner_term(m, cfg, U1):
    """The joiner's enc_proj (a frame) and pred_proj (a label position of a
    segment): (FLOPs an audio-second fwd+bwd, parameters)."""
    V, J, Ep = m.vocab_size, m.rnnt_joiner_dim, m.rnnt_pred_emb_dim
    flops = 3 * 2 * V * J * FRAMES + 3 * 2 * Ep * J * U1 / cfg.data.target_duration
    return flops, V * Ep + V * J + Ep * J + J * V


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode,band", [("ctc", 0), ("rnnt", 0), ("rnnt", -1)])
@pytest.mark.parametrize("encoder", sorted(ENCODERS))
def test_flops_and_bytes_match_jax(encoder, mode, band, dtype):
    argv = ENCODERS[encoder] + ["--model.dtype", dtype, "--train.mode", mode,
                                "--train.rnnt_band", str(band)]
    cfg = Config().apply_overrides(argv)
    m = cfg.model
    assert m.input_proj_dim == -1
    port, jax_ = _both(argv, mode)
    flops, params = 0.0, 0
    if encoder == "lstm":
        f, p = _lstm_term(m)
        flops, params = flops + f * FRAMES, params + p
    if encoder == "native":
        f, p = _native_term(m, 80)
        flops, params = flops + f * FRAMES, params + p
    if mode == "rnnt":
        f, p = _joiner_term(m, cfg, U + 1)
        flops, params = flops + f, params + p
    assert port.flops_per_audio_sec == pytest.approx(jax_.flops_per_audio_sec + flops, rel=1e-12)
    assert port.bytes_per_audio_sec == pytest.approx(
        jax_.bytes_per_audio_sec + _adam_bytes(params, cfg), rel=1e-12)


def _xlstm_defaults():
    """The xLSTM of the config: 3 blocks under num_layers 4."""
    argv = ["--model.encoder", "xlstm"]
    cfg = Config().apply_overrides(argv)
    assert (cfg.model.xlstm.num_blocks, cfg.model.num_layers) == (3, 4)
    port, jax_ = _both(argv)
    # the JAX module at num_layers 3 counts the 3 blocks the model has
    same, _ = _both(argv + ["--model.num_layers", "3"])
    assert port.flops_per_audio_sec == pytest.approx(same.flops_per_audio_sec, rel=1e-12)
    assert port.bytes_per_audio_sec == pytest.approx(same.bytes_per_audio_sec, rel=1e-12)
    # one block at E=512, 2 heads, dqk 128, dv 256, chunk 128, d_ff 1365:
    # projections 2·512·(2·256 + 2·512 + 4) + 2·512·512 = 2,101,248; SwiGLU
    # 6·512·1365 = 4,193,280; mixer 2·2·(128·128·2 + 128·256 + 2·128·256)
    # = 524,288; fwd+bwd 3×, 100 frames
    return jax_.flops_per_audio_sec - port.flops_per_audio_sec, 3 * 6_818_816 * 100


def _lstm_defaults():
    # h·w_hh: 4 layers × 2·512·2048 a frame, 3× with the backward, 100 frames
    port, jax_ = _both(["--model.encoder", "lstm"])
    assert port.bytes_per_audio_sec - jax_.bytes_per_audio_sec == pytest.approx(
        4 * 512 * 2048 * 28 / (32 * 16), rel=1e-12)            # w_hh's Adam bytes
    return port.flops_per_audio_sec - jax_.flops_per_audio_sec, 2_516_582_400


def _input_proj():
    # 80 MFCCs → 256, two frames stacked: 50 encoder frames an audio-second,
    # each fed 512 features (the JAX module counts 160).  The projection
    # 2·80·256 twice a frame; the first gate projection 2·(512 − 160)·7·512
    # more
    argv = ["--model.encoder", "lucyrnn", "--model.input_proj_dim", "256",
            "--model.stack_order", "2"]
    port, jax_ = _both(argv)
    assert port.bytes_per_audio_sec - jax_.bytes_per_audio_sec == pytest.approx(
        (80 * 256 + 352 * 7 * 512) * 28 / (32 * 16), rel=1e-12)
    return (port.flops_per_audio_sec - jax_.flops_per_audio_sec,
            3 * (2 * 80 * 256 * 2 + 2 * 352 * 7 * 512) * 50)


def _native_defaults():
    # per frame, model: 2·80·512 + 10·512² + 3·(2·512² + 10·512²) = 12,140,544;
    # the JAX module: 12·80·512 + 3·12·512² = 9,928,704
    port, jax_ = _both(["--model.encoder", "lucyrnn", "--model.lucyrnn.variant", "native"])
    assert port.bytes_per_audio_sec - jax_.bytes_per_audio_sec == pytest.approx(
        ((80 * 512 + 6 * 512**2 + 3 * 7 * 512**2) - (80 * 6 * 512 + 3 * 6 * 512**2))
        * 28 / (32 * 16), rel=1e-12)
    return (port.flops_per_audio_sec - jax_.flops_per_audio_sec,
            3 * (12_140_544 - 9_928_704) * 100)


def _joiner_defaults():
    # enc_proj 2·1024·64 a frame; pred_proj 2·64·64 at 129 positions a 16 s
    # segment; 3× with the backward
    port, jax_ = _both(["--model.encoder", "lucyrnn", "--train.mode", "rnnt"], "rnnt")
    assert port.bytes_per_audio_sec - jax_.bytes_per_audio_sec == pytest.approx(
        (1024 * 64 * 3 + 64 * 64) * 28 / (32 * 16), rel=1e-12)
    return (port.flops_per_audio_sec - jax_.flops_per_audio_sec,
            3 * 2 * 1024 * 64 * 100 + 3 * 2 * 64 * 64 * 129 / 16)


def _tracks():
    # two tracks of the 4 × 512 stack and a 1024 → 512 merge, where the JAX
    # module counts one track: 2·80·3584 + 3·2·512·3584 + 2·1024·512 more a
    # frame; the per-layer bytes of a second track
    argv = ["--model.encoder", "lucyrnn", "--model.lucyrnn.num_tracks", "2"]
    port, jax_ = _both(argv)
    stack = 80 * 3584 + 3 * 512 * 3584
    per_layer = 2 * 2 * 7 * 512 * 4 + 2 * (2 * 512 * 4 * 4) + 2 * 2 * 512 * 4
    assert port.bytes_per_audio_sec - jax_.bytes_per_audio_sec == pytest.approx(
        4 * per_layer * 100 + (stack + 1024 * 512) * 28 / (32 * 16), rel=1e-12)
    return (port.flops_per_audio_sec - jax_.flops_per_audio_sec,
            3 * 2 * (stack + 1024 * 512) * 100)


@pytest.mark.parametrize("case", [_xlstm_defaults, _lstm_defaults, _input_proj,
                                  _native_defaults, _joiner_defaults, _tracks],
                         ids=lambda f: f.__name__.strip("_"))
def test_recorded_difference_has_its_exact_size(case):
    got, want = case()
    assert got == pytest.approx(want, rel=1e-12)
    assert got > 0


def test_bound_of_ctc_f32_by_hand():
    """LucyRNN-CTC, f32, B=32, 16 s, U=128: compute-bound at the f32 peak."""
    r = train_step_roofline(Config().apply_overrides(["--model.encoder", "lucyrnn"]), 80, 128)
    # GEMMs a frame: 2·80·3584 + 3·2·512·3584 + 2·512·1024 = 12,632,064
    gemm = 3 * 12_632_064 * 100 / 67e12
    # bytes a frame: 4 layers × (gates 2·2·3584·4 + scans 32,768), the
    # activations 2·2·4·512·4, logits 3·2·1024·4, CTC 4·2·257·4 = 426,016;
    # Adam 6,316,032 parameters × 28 B over 32 × 16 s
    nbytes = 426_016 * 100 + 6_316_032 * 28 / 512
    assert r.bytes_per_audio_sec == pytest.approx(nbytes, rel=1e-12)
    assert gemm > nbytes / 3.35e12
    assert r.sol_audio_sec_per_sec == pytest.approx(1 / gemm, rel=1e-12)


def test_bound_of_banded_rnnt_bf16_by_hand():
    """RNN-T, bf16, B=96, 16 s, U=128 under the default band (32; Wp 48):
    bytes-bound."""
    cfg = Config().apply_overrides(["--model.encoder", "lucyrnn", "--model.dtype", "bfloat16",
                                    "--train.mode", "rnnt", "--data.batch_size", "96"])
    r = train_step_roofline(cfg, 80, 128, "rnnt")
    # GEMMs a frame 12,632,064 + enc_proj 2·1024·64; pred_proj 2·64·64 × 129
    # a 16 s segment; the joint 8·48·64·1024 a frame; all at the bf16 peak
    t_flops = (3 * (12_632_064 + 131_072) * 100 + 3 * 2 * 64 * 64 * 129 / 16
               + 8 * 48 * 64 * 1024 * 100) / 989e12
    # bytes a frame: 4 × (2·2·3584·2 + 32,768) + 2·2·4·512·2 + 3·2·1024·4 +
    # 5·2·129·4 = 291,880; Adam (6,316,032 + the joiner's 200,704) × 28 B
    # over 96 × 16 s
    nbytes = 291_880 * 100 + 6_516_736 * 28 / (96 * 16)
    t_exp = 2 * 48 * 1024 * 100 / (16 * 132 * 1.98e9)
    assert r.bytes_per_audio_sec == pytest.approx(nbytes, rel=1e-12)
    assert nbytes / 3.35e12 > max(t_flops, t_exp)
    assert r.sol_audio_sec_per_sec == pytest.approx(3.35e12 / nbytes, rel=1e-12)
    # one rate for every family, as the JAX module's peak_flops
    slow = train_step_roofline(cfg, 80, 128, "rnnt", peak_flops=1e12)
    assert slow.sol_audio_sec_per_sec == pytest.approx(
        1e12 / (t_flops * 989e12), rel=1e-12)


def test_mfu_is_model_flops_over_the_bf16_peak():
    r = train_step_roofline(Config().apply_overrides(["--model.encoder", "lucyrnn"]))
    assert r.mfu(1000.0) == pytest.approx(1000.0 * r.flops_per_audio_sec / 989e12, rel=1e-15)
    assert r.pct_sol(r.sol_audio_sec_per_sec) == pytest.approx(1.0)


def test_module_holds_no_tpu_constant():
    src = Path(roofline.__file__).read_text()
    for text in ("V5E", "v5e", "197e12", "819e9", "2.4e11"):
        assert text not in src, text
    numbers = {n.value for n in ast.walk(ast.parse(src)) if isinstance(n, ast.Constant)
               and isinstance(n.value, float)}
    assert not numbers & {197e12, 819e9, 2.4e11}
    assert roofline.H100_EXP_PER_S == pytest.approx(4.18176e12, rel=1e-12)


def test_unknown_encoder_raises():
    cfg = Config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, encoder="conformer"))
    with pytest.raises(ValueError, match="conformer"):
        train_step_roofline(cfg)
