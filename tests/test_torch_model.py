"""PyTorch port model (statecatcher_tpu_torch/models) against the JAX
package on the same weights, and the flax ⇄ torch weight bridge.

The whole-model comparison runs in float64 on both sides: LucyRNN's
h_pre/sqrt(h_pre²+ε) normalisation amplifies round-off by up to ε^{-1/2} =
1e3 per layer, so an f32 comparison would measure matmul summation order,
not the port.  In f64 the two agree to ~1e-12; they are held at rtol 1e-9,
atol 1e-10.  (flax's LayerNorm takes the variance as E[x²]−E[x]², PyTorch in
two passes — invisible at this precision.)  JAX runs the sequential
``xla-scan`` recurrence, the port its plain version on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from statecatcher_tpu.config import Config as JConfig
from statecatcher_tpu.models.asr import build_model as j_build_model
from statecatcher_tpu.models.speech import build_speech_model as j_build_speech
from statecatcher_tpu_torch.config import Config
from statecatcher_tpu_torch.convert import flax_to_torch, torch_to_flax
from statecatcher_tpu_torch.models.asr import build_model, init_carry
from statecatcher_tpu_torch.models.lstm import LSTMEncoder
from statecatcher_tpu_torch.models.rwkv import RWKVEncoder
from statecatcher_tpu_torch.models.speech import build_speech_model
from statecatcher_tpu_torch.testing import levenshtein, randomize_

B, T, F, D, L, V = 2, 20, 8, 10, 2, 12


def _overrides(tracks, stack, proj, d=D):
    return [
        "--model.encoder", "lucyrnn", "--model.hidden_size", str(d),
        "--model.num_layers", str(L), "--model.vocab_size", str(V),
        "--model.lucyrnn.num_tracks", str(tracks), "--model.stack_order", str(stack),
        "--model.input_proj_dim", str(proj),
        "--model.lucyrnn.kernel_impl", "xla-scan",
        "--model.dtype", "float64", "--model.param_dtype", "float64",
    ]


def _randomize(params, seed):
    """Random weights everywhere (the output projection is zero at init, so
    the logits would carry no signal otherwise)."""
    rng = np.random.default_rng(seed)

    def draw(x):
        x = np.asarray(x)
        if x.ndim == 2:
            return rng.standard_normal(x.shape) * (1.5 / np.sqrt(x.shape[0]))
        return x + 0.1 * rng.standard_normal(x.shape)

    return jax.tree_util.tree_map(draw, jax.device_get(params))


def _segments(cfg, seed):
    """3 segments of features, a random start carry, and a partial frame mask
    (at the stacked rate) on the last segment."""
    rng = np.random.default_rng(seed)
    feats = [rng.standard_normal((B, T, F)) * 2.0 for _ in range(3)]
    Te = T // cfg.model.stack_order
    mask = np.ones((B, Te), bool)
    mask[1, Te // 2:] = False
    shape = (B, cfg.model.lucyrnn.num_tracks, L, cfg.model.hidden_size)
    carry = {"h": rng.standard_normal(shape) * 0.3, "s": rng.standard_normal(shape) * 0.3}
    return feats, [None, None, mask], carry


def _run_both(kind, tracks, stack, proj, extra=(), d=D):
    ov = _overrides(tracks, stack, proj, d) + list(extra)
    jcfg, cfg = JConfig().apply_overrides(ov), Config().apply_overrides(ov)
    feats, masks, carry0 = _segments(cfg, seed=tracks * 100 + stack * 10 + max(proj, 0))
    with jax.enable_x64(True):
        jmodel = (j_build_speech(jcfg.model, F, "ctc") if kind == "speech"
                  else j_build_model(jcfg.model, F))
        params = _randomize(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(feats[0])), 1)
        jcarry = {k: jnp.asarray(v) for k, v in carry0.items()}
        jout = []
        for x, m in zip(feats, masks):
            logits, jcarry = jmodel.apply(params, jnp.asarray(x), jcarry,
                                          None if m is None else jnp.asarray(m))
            jout.append((np.asarray(logits), {k: np.asarray(v) for k, v in jcarry.items()}))

    build = build_speech_model if kind == "speech" else build_model
    tmodel = build(cfg.model, F, device="cpu")
    tmodel.load_state_dict(flax_to_torch(params, cfg.model))
    tcarry = {k: torch.from_numpy(v) for k, v in carry0.items()}
    tout = []
    with torch.inference_mode():
        for x, m in zip(feats, masks):
            logits, tcarry = tmodel(torch.from_numpy(x), tcarry,
                                    None if m is None else torch.from_numpy(m))
            tout.append((logits.numpy(), {k: v.numpy() for k, v in tcarry.items()}))
    return jout, tout


@pytest.mark.parametrize("proj", [-1, 24])
@pytest.mark.parametrize("stack", [1, 2])
@pytest.mark.parametrize("tracks", [1, 2])
def test_asr_model_matches_jax_over_carried_segments(tracks, stack, proj):
    jout, tout = _run_both("asr", tracks, stack, proj)
    for (jl, jc), (tl, tc) in zip(jout, tout):
        assert tl.dtype == np.float64 and tl.shape == jl.shape
        np.testing.assert_allclose(tl, jl, rtol=1e-9, atol=1e-10)
        for k in ("h", "s"):
            np.testing.assert_allclose(tc[k], jc[k], rtol=1e-9, atol=1e-10)


def test_speech_model_matches_jax_over_carried_segments():
    jout, tout = _run_both("speech", 2, 2, 24)
    for (jl, jc), (tl, tc) in zip(jout, tout):
        np.testing.assert_allclose(tl, jl, rtol=1e-9, atol=1e-10)
        for k in ("h", "s"):
            np.testing.assert_allclose(tc[k], jc[k], rtol=1e-9, atol=1e-10)


def test_any_variant_but_native_is_the_7_gate_cell():
    # as in the JAX package (models/asr.py builds LucyRNNEncoder for every
    # variant but "native"), through convert.py's 7-gate mapping
    extra = ["--model.lucyrnn.variant", "reference"]
    cfg = Config().apply_overrides(_overrides(1, 1, -1, 16) + extra)
    assert init_carry(cfg.model, B, device="cpu")["h"].shape == (B, 1, L, 16)
    jout, tout = _run_both("asr", 1, 1, -1, extra, d=16)
    for (jl, jc), (tl, tc) in zip(jout, tout):
        assert tl.shape == jl.shape == (B, T, V)
        np.testing.assert_allclose(tl, jl, rtol=1e-9, atol=1e-10)
        for k in ("h", "s"):
            np.testing.assert_allclose(tc[k], jc[k], rtol=1e-9, atol=1e-10)


@pytest.mark.parametrize("kind", ["asr", "speech"])
def test_weight_bridge_round_trips_bit_exactly(kind):
    ov = _overrides(2, 2, 24)[:-4]                       # float32 params
    jcfg, cfg = JConfig().apply_overrides(ov), Config().apply_overrides(ov)
    jmodel = j_build_speech(jcfg.model, F, "ctc") if kind == "speech" else j_build_model(jcfg.model, F)
    params = _randomize(jmodel.init(jax.random.PRNGKey(3), jnp.zeros((B, T, F))), 2)
    params = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), params)
    sd = flax_to_torch(params, cfg.model)
    build = build_speech_model if kind == "speech" else build_model
    tmodel = build(cfg.model, F, device="cpu")
    tmodel.load_state_dict(sd)                           # strict: every name matches
    back = torch_to_flax(tmodel.state_dict(), cfg.model)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_carry_layout_and_dtype():
    cfg = Config().apply_overrides(_overrides(2, 1, -1)[:-4] + ["--model.carry_dtype", "float64"])
    c = init_carry(cfg.model, 3, device="cpu")
    assert c["h"].shape == c["s"].shape == (3, 2, L, D)
    assert c["h"].dtype == torch.float64
    model = build_model(cfg.model, F, device="cpu")
    with torch.inference_mode():
        logits, state = model(torch.zeros(3, T, F), c)
    assert logits.dtype == torch.float32 and state["h"].dtype == torch.float64


@pytest.mark.parametrize("override", [
    ["--model.encoder", "lstm"],
    ["--model.encoder", "rwkv"],
])
def test_unported_models_raise(override):
    # xlstm (tests/test_torch_xlstm.py), LucyRNN's native variant
    # (tests/test_torch_lucyrnn_native.py), the LSTM (tests/test_torch_lstm.py)
    # and RWKV (tests/test_torch_rwkv.py) are ported: each builds, in both
    # modes
    cfg = Config().apply_overrides(override)
    want = {"lstm": LSTMEncoder, "rwkv": RWKVEncoder}[cfg.model.encoder]
    assert isinstance(build_model(cfg.model, F, device="cpu").encoder, want)
    assert build_speech_model(cfg.model, F, "rnnt", device="cpu").joiner is not None


def test_randomize_is_seeded_and_offsets_gate_biases():
    cfg = Config().apply_overrides(_overrides(1, 1, -1)[:-4])
    a, b = (build_model(cfg.model, F, device="cpu") for _ in range(2))
    randomize_(a, 7)
    randomize_(b, 7)
    for (name, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), name
    for l in range(L):
        bias = getattr(a.encoder, f"track0_layer{l}").gate_proj.bias.detach()
        assert (bias[2 * D:4 * D].abs() > 1.5).all()        # k, v away from 0
        assert (bias[4 * D:5 * D].abs() > 0.5).all()        # h_pre away from 0
    assert a.encoder.output_proj.weight.abs().min() > 0     # zero at init


@pytest.mark.parametrize("a,b,want", [
    ([], [], 0), ([1, 2, 3], [], 3), ([1, 2, 3], [1, 2, 3], 0),
    ([1, 2, 3], [1, 3], 1), ([1, 2, 3], [1, 4, 3], 1), ([3, 2, 1], [1, 2, 3], 2),
])
def test_levenshtein(a, b, want):
    assert levenshtein(a, b) == levenshtein(b, a) == want
