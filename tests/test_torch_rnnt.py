"""RNN-T model and loss of the PyTorch port (statecatcher_tpu_torch/models/
rnnt.py, models/speech.py mode="rnnt", ops/rnnt.py) against the JAX package,
the weight bridge of the joiner, and the loss dispatch on the card.

  * The joiner (project, joint, decode_tables, project_encoder) in float32 on
    converted weights: 1e-6 (sums of at most 64 products of O(1) values).
  * SpeechModel(mode="rnnt") forward in float64 on both sides (as
    tests/test_torch_model.py: LucyRNN's h_pre normalisation amplifies f32
    round-off to ~1e-5 in the encoder output): 1e-9 relative plus 1e-10.
  * ``rnnt_loss`` and ``rnnt_loss_fused`` and their gradients in float64 on
    both sides: the JAX functions cast logits to float32 (``astype``), read
    here as float64 (``_JnpF64``) so both sides compute in float64; loss to
    relative 1e-9, gradients to 1e-7 of their scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import statecatcher_tpu.ops.rnnt as j_rnnt_module
from statecatcher_tpu.config import Config as JConfig
from statecatcher_tpu.models.asr import init_carry as j_init_carry
from statecatcher_tpu.models.rnnt import make_prefix as j_make_prefix
from statecatcher_tpu.models.speech import build_speech_model as j_build_speech
from statecatcher_tpu_torch.config import Config
from statecatcher_tpu_torch.convert import flax_to_torch, torch_to_flax
from statecatcher_tpu_torch.models.asr import init_carry
from statecatcher_tpu_torch.models.rnnt import make_prefix
from statecatcher_tpu_torch.models.speech import build_speech_model
from statecatcher_tpu_torch.ops import rnnt as trnnt
from statecatcher_tpu_torch.ops.rnnt_joint import rnnt_joint_bwd, rnnt_joint_fwd
from statecatcher_tpu_torch.ops.rnnt_lattice import rnnt_alpha, rnnt_beta
from statecatcher_tpu_torch.testing import randomize_
from statecatcher_tpu_torch.train.step import resolve_rnnt_band, resolve_rnnt_impl
from test_torch_cuda import single_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_torch_thread")

B, T, F, U, V = 2, 14, 80, 5, 30
OVERRIDES = ["--model.encoder", "lucyrnn", "--model.hidden_size", "16", "--model.num_layers", "2",
             "--model.vocab_size", str(V), "--model.lucyrnn.kernel_impl", "xla-scan",
             "--model.rnnt_pred_emb_dim", "12", "--model.rnnt_joiner_dim", "20"]


class _JnpF64:
    """``jax.numpy`` with ``float32`` read as ``float64``."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


def _models(overrides):
    """The port's SpeechModel(mode="rnnt") with randomize_'s weights, and the
    JAX model with the same weights (torch → flax)."""
    cfg, jcfg = Config().apply_overrides(overrides), JConfig().apply_overrides(overrides)
    model = build_speech_model(cfg.model, F, "rnnt", device="cpu",
                               generator=torch.Generator().manual_seed(0))
    randomize_(model, 1)
    params = torch_to_flax(model.state_dict(), cfg.model)
    return cfg, model, jcfg, j_build_speech(jcfg.model, F, "rnnt"), params


@pytest.fixture(scope="module")
def models():
    return _models(OVERRIDES)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((B, T, F)).astype(np.float32)
    labels = rng.integers(1, V, (B, U)).astype(np.int32)
    return feats, labels


def _close(got, want, rtol=1e-6, atol=1e-6, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=what)


def test_joiner_matches_jax(models):
    cfg, model, _, jmodel, params = models
    rng = np.random.default_rng(2)
    enc_out = rng.standard_normal((B, T, V)).astype(np.float32)
    _, labels = _inputs(3)
    prefix = make_prefix(torch.from_numpy(labels), 0)
    np.testing.assert_array_equal(prefix.numpy(), np.asarray(j_make_prefix(jnp.asarray(labels), 0)))
    with torch.inference_mode():
        got = model.rnnt_project(torch.from_numpy(enc_out), prefix)
        got_joint = model.rnnt_joint_logits(torch.from_numpy(enc_out), prefix)
        got_tables = model.rnnt_decode_tables()
        got_enc = model.rnnt_project_encoder(torch.from_numpy(enc_out))
    want = jmodel.apply(params, jnp.asarray(enc_out), jnp.asarray(prefix.numpy()),
                        method="rnnt_project")
    for name, a, b in zip(("enc_p", "pred_p", "join_kernel", "join_bias"), got, want):
        _close(a.detach().numpy(), b, what=name)
    assert got[0].shape == (B, T, 20) and got[1].shape == (B, U + 1, 20)
    _close(got_joint.numpy(), jmodel.apply(params, jnp.asarray(enc_out), jnp.asarray(prefix.numpy()),
                                           method="rnnt_joint_logits"), what="joint logits")
    for name, a, b in zip(("pred_table", "join_kernel", "join_bias"), got_tables,
                          jmodel.apply(params, method="rnnt_decode_tables")):
        _close(a.detach().numpy(), b, what=name)
    _close(got_enc.numpy(), jmodel.apply(params, jnp.asarray(enc_out),
                                         method="rnnt_project_encoder"), what="project_encoder")


def test_speech_model_rnnt_forward_matches_jax():
    cfg, model, jcfg, jmodel, params = _models(
        OVERRIDES + ["--model.dtype", "float64", "--model.param_dtype", "float64"])
    feats, labels = (x.astype(np.float64) if x.dtype == np.float32 else x for x in _inputs(4))
    rng = np.random.default_rng(5)
    carry = {k: 0.1 * rng.standard_normal(v.shape)
             for k, v in init_carry(cfg.model, B, device="cpu").items()}
    mask = np.ones((B, T), bool)
    mask[1, T - 4:] = False
    prefix = make_prefix(torch.from_numpy(labels), 0)
    with torch.inference_mode():
        enc, state, proj = model(torch.from_numpy(feats), {k: torch.from_numpy(v) for k, v in carry.items()},
                                 torch.from_numpy(mask), prefix)
        enc_only, _ = model(torch.from_numpy(feats))
    with jax.enable_x64(True):
        jenc, jstate, jproj = jax.jit(jmodel.apply)(params, jnp.asarray(feats),
                                           {k: jnp.asarray(v) for k, v in carry.items()},
                                           jnp.asarray(mask), jnp.asarray(prefix.numpy()))
    assert enc_only.shape == (B, T, V) and enc.dtype == torch.float64
    _close(enc.numpy(), jenc, 1e-9, 1e-10, "encoder output")
    for k in ("h", "s"):
        _close(state[k].numpy(), jstate[k], 1e-9, 1e-10, f"carry {k}")
    for name, a, b in zip(("enc_p", "pred_p"), proj[:2], jproj[:2]):
        _close(a.numpy(), b, 1e-9, 1e-10, name)


def test_weight_bridge_round_trip_rnnt_is_bit_exact():
    jcfg = JConfig().apply_overrides(OVERRIDES)
    cfg = Config().apply_overrides(OVERRIDES)
    jmodel = j_build_speech(jcfg.model, F, "rnnt")
    # the flax tree's structure, shapes and dtypes, filled with random values
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(7), jnp.zeros((1, 8, F)),
                            j_init_carry(jcfg.model, 1), None, jnp.zeros((1, 2), jnp.int32))
    rng = np.random.default_rng(8)
    params = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(x.dtype), shapes)
    sd = flax_to_torch(params, cfg.model)
    assert sd["joiner.join_kernel"].shape == (20, V)             # the JAX layout (J, V)
    assert sd["joiner.enc_proj.weight"].shape == (20, V)         # (out, in)
    model = build_speech_model(cfg.model, F, "rnnt", device="cpu")
    model.load_state_dict(sd)                                    # strict: names and shapes
    back = torch_to_flax(model.state_dict(), cfg.model)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _loss_problem(seed, blank_id):
    rng = np.random.default_rng(seed)
    Bq, Tq, Uq, J, Vq = 3, 11, 4, 6, 9
    enc = rng.standard_normal((Bq, Tq, J))
    pred = rng.standard_normal((Bq, Uq + 1, J))
    k = rng.standard_normal((J, Vq)) * 0.5
    b = rng.standard_normal(Vq) * 0.3
    labels = rng.integers(0, Vq - 1, (Bq, Uq)).astype(np.int32)
    labels[labels >= blank_id] += 1                              # labels avoid the blank
    t_lens = np.array([Tq, Tq - 3, Tq - 5], np.int32)
    u_lens = np.array([Uq, 0, Uq - 2], np.int32)
    row_valid = np.array([True, True, False])
    return enc, pred, k, b, labels, t_lens, u_lens, row_valid


def _grads_close(got, want, what):
    for g, w, name in zip(got, want, ("enc", "pred", "kernel", "bias")):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-7 * np.abs(w).max(), err_msg=f"{what} {name}")


@pytest.mark.parametrize("blank_id,use_valid", [(0, False), (3, True)])
def test_fused_loss_and_grads_match_jax_f64(blank_id, use_valid, monkeypatch):
    enc, pred, k, b, labels, t_lens, u_lens, row_valid = _loss_problem(10 + blank_id, blank_id)
    rv = row_valid if use_valid else None
    monkeypatch.setattr(j_rnnt_module, "jnp", _JnpF64())
    with jax.enable_x64(True):
        f = lambda *a: j_rnnt_module.rnnt_loss_fused(
            *a, jnp.asarray(labels), jnp.asarray(t_lens), jnp.asarray(u_lens), blank_id=blank_id,
            row_valid=None if rv is None else jnp.asarray(rv), time_chunk=4)
        jl, jg = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2, 3)))(
            *map(jnp.asarray, (enc, pred, k, b)))
    xs = [torch.from_numpy(x).requires_grad_() for x in (enc, pred, k, b)]
    loss, per = trnnt.rnnt_loss_fused(*xs, torch.from_numpy(labels), torch.from_numpy(t_lens),
                                      torch.from_numpy(u_lens), blank_id=blank_id,
                                      row_valid=None if rv is None else torch.from_numpy(rv),
                                      time_chunk=4, return_per=True)
    loss.backward()
    assert loss.dtype == torch.float64 and per.shape == (3,)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-9)
    _grads_close([x.grad.numpy() for x in xs], jg, "fused")
    if use_valid:
        assert not xs[0].grad[2].any()                           # the invalid row: no gradient


@pytest.mark.parametrize("blank_id,use_valid", [(0, True), (4, False)])
def test_dense_loss_and_grad_match_jax_f64(blank_id, use_valid, monkeypatch):
    enc, pred, k, b, labels, t_lens, u_lens, row_valid = _loss_problem(20 + blank_id, blank_id)
    logits = np.tanh(enc[:, :, None] + pred[:, None]) @ k + b          # (B, T, U+1, V)
    rv = row_valid if use_valid else None
    monkeypatch.setattr(j_rnnt_module, "jnp", _JnpF64())
    with jax.enable_x64(True):
        f = lambda x: j_rnnt_module.rnnt_loss(x, jnp.asarray(labels), jnp.asarray(t_lens),
                                              jnp.asarray(u_lens), blank_id=blank_id,
                                              row_valid=None if rv is None else jnp.asarray(rv))
        jl, jg = jax.jit(jax.value_and_grad(f))(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    loss = trnnt.rnnt_loss(x, torch.from_numpy(labels), torch.from_numpy(t_lens),
                           torch.from_numpy(u_lens), blank_id=blank_id,
                           row_valid=None if rv is None else torch.from_numpy(rv))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-9)
    np.testing.assert_allclose(x.grad.numpy(), jg, rtol=0, atol=1e-7 * np.abs(jg).max())
    # the two front ends compute the same loss
    xs = [torch.from_numpy(a) for a in (enc, pred, k, b)]
    fused = trnnt.rnnt_loss_fused(*xs, torch.from_numpy(labels), torch.from_numpy(t_lens),
                                  torch.from_numpy(u_lens), blank_id=blank_id,
                                  row_valid=None if rv is None else torch.from_numpy(rv))
    np.testing.assert_allclose(fused.item(), loss.item(), rtol=1e-12)


def test_rnnt_dispatch_rule():
    """"auto" takes the kernels on the card and the fused loss on the CPU
    (ignoring the band there, as the JAX package does); a band > 0 on the
    kernel path raises, naming the banded kernel K8."""
    assert resolve_rnnt_band(-1, 48) == 0 and resolve_rnnt_band(-1, 64) == 32
    assert resolve_rnnt_band(0, 128) == 0 and resolve_rnnt_band(16, 16) == 16
    assert resolve_rnnt_impl("auto", 0, on_cuda=True) == "pallas"
    assert resolve_rnnt_impl("auto", 32, on_cuda=False) == "xla"
    assert resolve_rnnt_impl("xla", 32, on_cuda=True) == "xla"
    assert resolve_rnnt_impl("pallas", 0, on_cuda=False) == "pallas"
    for impl in ("auto", "pallas"):
        with pytest.raises(NotImplementedError, match="K8"):
            resolve_rnnt_impl(impl, resolve_rnnt_band(-1, 64), on_cuda=True)
    with pytest.raises(ValueError):
        resolve_rnnt_impl("bogus", 0, on_cuda=False)


def test_kernel_wrappers_run_plain_versions_on_cpu():
    """On CPU tensors the K6/K7 wrappers run their plain versions and launch
    nothing."""
    enc, pred, k, b, labels, t_lens, u_lens, _ = _loss_problem(30, 0)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    n = (rnnt_joint_fwd.launches, rnnt_joint_bwd.launches, rnnt_alpha.launches, rnnt_beta.launches)
    blank, emit, lse = rnnt_joint_fwd(f32(enc), f32(pred), f32(k), f32(b), torch.from_numpy(labels))
    assert blank.dtype == torch.float32 and emit.shape == (3, 11, 4) and lse.shape == (3, 11, 5)
    grads = rnnt_joint_bwd(f32(enc), f32(pred), f32(k), f32(b), torch.from_numpy(labels), lse,
                           torch.ones_like(blank), torch.ones_like(emit))
    assert [g.shape for g in grads] == [(3, 11, 6), (3, 5, 6), (6, 9), (9,)]
    rnnt_alpha(blank, emit, torch.from_numpy(t_lens))
    rnnt_beta(blank, emit, torch.from_numpy(t_lens), torch.from_numpy(u_lens))
    assert (rnnt_joint_fwd.launches, rnnt_joint_bwd.launches, rnnt_alpha.launches,
            rnnt_beta.launches) == n

