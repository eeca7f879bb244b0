"""The RWKV encoder of the PyTorch port (statecatcher_tpu_torch/models/rwkv.py,
the RWKV branch of models/asr.py and convert.py) against the JAX package on
the same inputs and weights.

  * ``wkv_parallel`` and ``ASRModel``'s RWKV encoder in float64 on both
    sides (JAX's float32 casts read as float64, ``_JnpF64``): the WKV output,
    all five carry leaves over three carried segments (the last with a frame
    mask) and the gradients of every input and parameter (``jax.grad``: no
    Pallas kernel here) within 1e-9 relative.
  * An f32 witness at T=1598, B=2, D=64 with the init's decays: the port's
    WKV is no further from a float64 step loop than JAX's f32 associative
    scan is, within 2× (its maximum and its root-mean-square error).
  * The RWKV-CTC ``make_segment_scan_step`` in lockstep with JAX's over 3
    updates (``tests/test_torch_train_step.py``'s harness and tolerances),
    the loss curve compared.
  * Carry across segments equals one segment; streaming equals offline.
  * The flax tree converts both ways bit for bit; the init's fixed leaves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import statecatcher_tpu.models.rwkv as j_rwkv
from statecatcher_tpu.config import Config as JConfig
from statecatcher_tpu.models.asr import build_model as j_build_model
from statecatcher_tpu_torch.config import Config
from statecatcher_tpu_torch.convert import flax_to_torch, torch_to_flax
from statecatcher_tpu_torch.decode import ctc_greedy_decode_to_lists
from statecatcher_tpu_torch.frontend import compute_features
from statecatcher_tpu_torch.models.asr import build_model, init_carry
from statecatcher_tpu_torch.models.rwkv import NEG, RWKVEncoder, wkv_parallel
from statecatcher_tpu_torch.models.speech import build_speech_model
from statecatcher_tpu_torch.streaming import StreamingRecognizer
from statecatcher_tpu_torch.testing import randomize_, synth_audio
import statecatcher_tpu_torch.train.step as step_module
from test_torch_cuda import single_torch_thread  # noqa: F401
from test_torch_train_step import (
    ATOL,
    RTOL,
    _close,
    _groups,
    _jax_features,
    _JnpF64,
    _run_jax,
    _run_torch,
)

pytestmark = pytest.mark.usefixtures("single_torch_thread")

B, T, F, D, L, V = 3, 13, 6, 8, 2, 11
KEYS = ("last_x_tm", "last_x_cm", "log_num_p", "log_num_n", "log_den")


def _overrides(dtype="float64"):
    return ["--model.encoder", "rwkv", "--model.hidden_size", str(D), "--model.num_layers",
            str(L), "--model.vocab_size", str(V), "--model.dtype", dtype,
            "--model.param_dtype", dtype]


def _wkv_inputs(rng, B_, T_, D_, empty):
    k, v = rng.standard_normal((2, B_, T_, D_))
    w = np.exp(np.linspace(-5.0, 1.0, D_)) * rng.uniform(0.8, 1.2, D_)
    u = 0.5 * rng.standard_normal(D_)
    if empty:
        state = tuple(np.full((B_, D_), NEG) for _ in range(3))
    else:
        state = tuple(rng.standard_normal((B_, D_)) for _ in range(3))
    return k, v, w, u, state


@pytest.mark.parametrize("empty", [True, False], ids=["empty", "carried"])
def test_wkv_parallel_matches_jax_float64(empty, monkeypatch):
    rng = np.random.default_rng(1)
    k, v, w, u, state = _wkv_inputs(rng, 2, 37, 5, empty)
    cot = rng.standard_normal((2, 37, 5))
    cot_s = rng.standard_normal((3, 2, 5))
    monkeypatch.setattr(j_rwkv, "jnp", _JnpF64())

    def j_loss(k, v, w, u, *state):
        out, new = j_rwkv.wkv_parallel(k, v, w, u, state)
        return (out * cot).sum() + sum((s * c).sum() for s, c in zip(new, cot_s)), (out, new)

    with jax.enable_x64(True):
        args = [jnp.asarray(a) for a in (k, v, w, u, *state)]
        (_, (jout, jnew)), jgrads = jax.value_and_grad(j_loss, argnums=tuple(range(7)),
                                                       has_aux=True)(*args)
        jout, jnew = np.asarray(jout), [np.asarray(s) for s in jnew]
        jgrads = [np.asarray(g) for g in jgrads]

    targs = [torch.tensor(a, dtype=torch.float64, requires_grad=True) for a in (k, v, w, u, *state)]
    out, new = wkv_parallel(*targs[:4], tuple(targs[4:]))
    loss = (out * torch.from_numpy(cot)).sum() + sum(
        (s * torch.from_numpy(c)).sum() for s, c in zip(new, cot_s))
    grads = torch.autograd.grad(loss, targs)
    np.testing.assert_allclose(out.detach().numpy(), jout, rtol=1e-9, atol=1e-12)
    for s, js in zip(new, jnew):
        np.testing.assert_allclose(s.detach().numpy(), js, rtol=1e-9, atol=1e-12)
    for name, g, jg in zip(("k", "v", "w", "u", "num_p", "num_n", "den"), grads, jgrads):
        np.testing.assert_allclose(g.numpy(), jg, rtol=1e-9, atol=1e-12 * np.abs(jg).max(),
                                   err_msg=name)


def _numpy_wkv(k, v, w, u):
    """The recurrence step by step in float64, unstabilised (the JAX
    package's own test reference)."""
    out = np.zeros_like(k)
    num = np.zeros(k.shape[::2])
    den = np.zeros(k.shape[::2])
    for t in range(k.shape[1]):
        ek_u = np.exp(u + k[:, t])
        out[:, t] = (num + ek_u * v[:, t]) / (den + ek_u)
        num = np.exp(-w) * num + np.exp(k[:, t]) * v[:, t]
        den = np.exp(-w) * den + np.exp(k[:, t])
    return out


def test_wkv_float32_witness_no_worse_than_jax():
    """At T=1598 with the init's decays (exp(linspace(−5, 1)), up to e) the
    decayed sums reach w·t ≈ 4300: the port's f32 WKV stays within 2× of
    the error of JAX's f32 associative scan, against float64."""
    Bw, Tw, Dw = 2, 1598, 64
    rng = np.random.default_rng(0)
    k, v = rng.standard_normal((2, Bw, Tw, Dw))
    w = np.exp(np.linspace(-5.0, 1.0, Dw))
    u = 0.5 * rng.standard_normal(Dw)
    want = _numpy_wkv(k, v, w, u)
    f32 = lambda a: np.asarray(a, np.float32)
    empty = np.full((Bw, Dw), NEG, np.float32)
    jout, _ = j_rwkv.wkv_parallel(*(jnp.asarray(f32(a)) for a in (k, v, w, u)),
                                  (jnp.asarray(empty),) * 3)
    with torch.inference_mode():
        out, _ = wkv_parallel(*(torch.from_numpy(f32(a)) for a in (k, v, w, u)),
                              (torch.from_numpy(empty),) * 3)
    err_j = np.abs(np.asarray(jout, np.float64) - want)
    err_t = np.abs(out.double().numpy() - want)
    assert out.dtype == torch.float32
    assert err_t.max() <= 2 * err_j.max(), (err_t.max(), err_j.max())
    assert np.sqrt((err_t ** 2).mean()) <= 2 * np.sqrt((err_j ** 2).mean())
    assert err_t.max() < 1e-4 * np.abs(want).max()


def _segments(seed):
    rng = np.random.default_rng(seed)
    feats = [rng.standard_normal((B, T, F)) for _ in range(3)]
    mask = np.ones((B, T), bool)
    mask[1, T // 2:] = False
    mask[2, 1] = False
    return feats, [None, None, mask]


def _models(dtype="float64"):
    ov = _overrides(dtype)
    cfg, jcfg = Config().apply_overrides(ov), JConfig().apply_overrides(ov)
    model = build_model(cfg.model, F, device="cpu", generator=torch.Generator().manual_seed(0))
    randomize_(model, 1)
    return cfg, jcfg, model, torch_to_flax(model.state_dict(), cfg.model)


def test_rwkv_asr_model_matches_jax_float64(monkeypatch):
    """Three carried segments, the last with a frame mask (which RWKV
    ignores but for ASRModel's zeroed inputs): logits and the five carry
    leaves; then the gradient of every parameter and of the features."""
    cfg, jcfg, model, params = _models()
    feats, masks = _segments(2)
    cots = [np.random.default_rng(10 + i).standard_normal((B, T, V)) for i in range(3)]
    monkeypatch.setattr(j_rwkv, "jnp", _JnpF64())
    with jax.enable_x64(True):
        jmodel = j_build_model(jcfg.model, F)
        jparams = jax.tree_util.tree_map(lambda p: jnp.asarray(p, jnp.float64), params)

        def run(p, xs):
            carry, out = None, []
            for x, m in zip(xs, masks):
                logits, carry = jmodel.apply(p, x, carry, None if m is None else jnp.asarray(m))
                out.append((logits, carry))
            return out

        jx = [jnp.asarray(x) for x in feats]
        jout = [(np.asarray(a), {k: np.asarray(c) for k, c in b.items()})
                for a, b in run(jparams, jx)]
        loss = lambda p, xs: sum((lg * c).sum() for (lg, _), c in zip(run(p, xs), cots))
        jgp, jgx = jax.grad(loss, argnums=(0, 1))(jparams, jx)
    assert jout[0][1]["log_num_p"].dtype == np.float64

    xs = [torch.tensor(x, requires_grad=True) for x in feats]
    carry, out = None, []
    for x, m in zip(xs, masks):
        logits, carry = model(x, carry, None if m is None else torch.from_numpy(m))
        out.append((logits, carry))
    for (jl, jc), (tl, tc) in zip(jout, out):
        np.testing.assert_allclose(tl.detach().numpy(), jl, rtol=1e-9, atol=1e-12)
        assert set(tc) == set(KEYS) and all(tc[k].shape == (B, L, D) for k in KEYS)
        for k in KEYS:
            np.testing.assert_allclose(tc[k].detach().numpy(), jc[k], rtol=1e-9, atol=1e-12,
                                       err_msg=k)
    sum((lg * torch.from_numpy(c)).sum() for (lg, _), c in zip(out, cots)).backward()
    grads = torch_to_flax({k: p.grad for k, p in model.named_parameters()}, cfg.model)
    for (path, g), (_, jg) in zip(jax.tree_util.tree_leaves_with_path(grads),
                                  jax.tree_util.tree_leaves_with_path(jgp)):
        jg = np.asarray(jg)
        np.testing.assert_allclose(g, jg, rtol=1e-9, atol=1e-12 * max(np.abs(jg).max(), 1.0),
                                   err_msg=jax.tree_util.keystr(path))
    for x, jg in zip(xs, jgx):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), rtol=1e-9, atol=1e-12)


def test_rwkv_bfloat16_carry_casts_every_leaf():
    """Under a bf16 carry every leaf, the log states too, leaves ASRModel in
    bf16 (JAX casts the whole tree); the empty carry's log states are f32."""
    ov = _overrides("float32") + ["--model.carry_dtype", "bfloat16"]
    cfg, jcfg = Config().apply_overrides(ov), JConfig().apply_overrides(ov)
    c0 = init_carry(cfg.model, B, device="cpu")
    assert c0["last_x_tm"].dtype == torch.bfloat16 and c0["log_den"].dtype == torch.float32
    assert (c0["log_den"] == NEG).all()
    model = build_model(cfg.model, F, device="cpu")
    with torch.inference_mode():
        _, carry = model(torch.zeros(B, T, F), c0)
    assert all(carry[k].dtype == torch.bfloat16 for k in KEYS)
    jc = jax.tree.map(lambda a: a.dtype, j_build_model(jcfg.model, F).init_state(B))
    assert {k: str(jc[k]) for k in KEYS} == {k: str(c0[k].dtype).split(".")[1] for k in KEYS}


def test_rwkv_carry_across_segments_equals_one_segment():
    enc = RWKVEncoder(F, V, D, L, dtype=torch.float64, param_dtype=torch.float64,
                      generator=torch.Generator().manual_seed(3))
    randomize_(enc, 4)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((B, 2 * T + 3, F)))
    with torch.inference_mode():
        y, st = enc(x)
        y1, st1 = enc(x[:, :T])
        y2, st2 = enc(x[:, T:], st1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y.numpy(), rtol=1e-10, atol=1e-12)
    for k in KEYS:
        np.testing.assert_allclose(st2[k].numpy(), st[k].numpy(), rtol=1e-10, atol=1e-12)


def test_rwkv_streaming_equals_offline():
    """Streamed in chunks of 8 frames the greedy tokens equal a one-shot
    encode of the same frames (float64, random weights)."""
    ov = _overrides("float64")[:-4] + ["--model.vocab_size", "13", "--model.dtype", "float64",
                                       "--model.param_dtype", "float64"]
    cfg = Config().apply_overrides(ov)
    model = build_speech_model(cfg.model, cfg.frontend.n_mfcc, device="cpu",
                               generator=torch.Generator().manual_seed(0))
    randomize_(model, 1)
    audio = synth_audio(np.random.default_rng(3), 1, 16000)[0]
    rec = StreamingRecognizer(model, cfg, chunk_frames=8, device="cpu")
    for pos in range(0, len(audio), 1234):
        rec.accept_waveform(audio[pos:pos + 1234])
    rec.finish()
    with torch.inference_mode():
        feats = compute_features(torch.from_numpy(audio[None]), cfg.frontend).double()
        lp = torch.log_softmax(model(feats)[0], -1)
    want = ctc_greedy_decode_to_lists(lp, torch.tensor([lp.shape[1]]))[0]
    assert want and rec.tokens == want


def test_rwkv_converts_both_ways_and_init_matches_jax():
    ov = _overrides("float32")
    cfg, jcfg = Config().apply_overrides(ov), JConfig().apply_overrides(ov)
    jparams = j_build_model(jcfg.model, F).init(jax.random.PRNGKey(0), jnp.zeros((1, 4, F)))
    sd = flax_to_torch(jparams, cfg.model)
    model = build_model(cfg.model, F, device="cpu")
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)
    back = torch_to_flax(model.state_dict(), cfg.model)
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(jparams["params"]),
                                jax.tree_util.tree_leaves_with_path(back["params"])):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(a), b)
    # the leaves flax initialises to constants, the port initialises alike
    own = build_model(cfg.model, F, device="cpu").state_dict()
    for key, value in own.items():
        if key.split(".")[-1] in ("mix_k", "mix_v", "mix_r", "time_decay", "time_first") or \
                key.startswith("encoder.vocab_proj") or key.endswith("bias"):
            np.testing.assert_allclose(value.numpy(), sd[key].numpy(), atol=1e-6, err_msg=key)
    assert (own["encoder.vocab_proj.weight"] == 0).all()


def test_rwkv_ctc_train_step_matches_jax_in_lockstep(monkeypatch):
    """Three updates (two groups of two segments, the last one skipped by
    ``seg_valid``) of a 2 × 16 RWKV-CTC, float64 on both sides: losses,
    grad norms, greedy outputs, parameters and carry at the harness's
    tolerances."""
    ov = ["--model.encoder", "rwkv", "--model.hidden_size", "16", "--model.num_layers", "2",
          "--model.vocab_size", "24", "--model.dtype", "float64",
          "--model.param_dtype", "float64", "--train.optim.lr", "3e-3"]
    cfg, jcfg = Config().apply_overrides(ov), JConfig().apply_overrides(ov)
    model = build_speech_model(cfg.model, 80, "ctc", device="cpu",
                               generator=torch.Generator().manual_seed(0))
    randomize_(model, 1)
    params = torch_to_flax(model.state_dict(), cfg.model)
    groups = _groups("seg_invalid", seed=5)
    monkeypatch.setattr(j_rwkv, "jnp", _JnpF64())
    want = _run_jax(jcfg, params, groups, monkeypatch)
    monkeypatch.setattr(step_module, "compute_features", _jax_features(jcfg.frontend))
    got = _run_torch(cfg, model, groups)

    curve, jcurve = [], []
    for g, ((t_out, t_par, t_car), (j_out, j_par, j_car)) in enumerate(zip(got, want)):
        for k in ("loss", "grad_norm", "per_loss"):
            _close(t_out[k], j_out[k], RTOL[k], 0, f"group {g} {k}")
        np.testing.assert_array_equal(t_out["preds"], j_out["preds"])
        np.testing.assert_array_equal(t_out["keep"], j_out["keep"])
        for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(t_par),
                                     jax.tree_util.tree_leaves_with_path(j_par)):
            _close(a, b, RTOL["params"], ATOL["params"], f"group {g} {jax.tree_util.keystr(path)}")
        for k in KEYS:
            _close(t_car[k], j_car[k], RTOL["carry"], ATOL["carry"], f"group {g} carry {k}")
        valid = groups[g][5]
        curve += list(t_out["loss"][valid])
        jcurve += list(j_out["loss"][valid])
    assert len(curve) == 3 and np.all(np.isfinite(curve))
    _close(curve, jcurve, RTOL["loss"], 0, "loss curve")
