"""The transducer joint of the PyTorch port above J = 128 (where the card
runs the tiled products of ``ops/csrc/rnnt_joint_core.cuh``) against the JAX
package, whose joint pads J + 1 to whole 128-lane tiles and so takes any
joiner width: J = 200 (ragged in the port's 64-wide slices and in JAX's
128-lane tiles) and 640 (NeMo Conformer-Transducer's ``joint_hidden``).

- The forward tables of K6 (``joint_blank_emit``) and K8
  (``joint_blank_emit_banded``), the port's plain versions against JAX's
  Pallas kernels in interpret mode (as tests/test_torch_rnnt_joint.py and
  tests/test_torch_rnnt_band.py run them), blank_id 7: 1e-5, float32.
- The gradients against JAX's XLA forms, never through an interpret-mode
  kernel: the joint's weighted blank and emit sums against
  ``blank_emit_from_log_probs`` of the XLA log-softmax, and the exact and
  full-band losses against ``rnnt_loss_fused``: losses to 1e-5, gradients
  2e-4 relative (the JAX tests') plus 2e-5 of each gradient's largest
  value.  The JAX tests' absolute 2e-5 is not kept: at J = 640 d_kernel
  reaches ~5, and its f32 sums over the rows, in JAX's chunks and in the
  port's, differ by ~1e-5 of that (5.3e-5 at most, measured).
- One training step at ``rnnt_joiner_dim`` 640 with a tiny encoder, in
  lockstep with JAX's: the exact loss (the port's K6/K7 plain versions
  against JAX's XLA ``rnnt_loss_fused``) and the banded one (the port's K8
  plain version against JAX's interpret-mode kernel), float32, with
  tests/test_torch_rnnt_band_step.py's tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import statecatcher_tpu.ops.rnnt_band as jrb
import statecatcher_tpu_torch.train.step as step_module
from statecatcher_tpu.config import Config as JConfig
from statecatcher_tpu.models.asr import init_carry as j_init_carry
from statecatcher_tpu.models.speech import build_speech_model as j_build_speech
from statecatcher_tpu.ops import rnnt_pallas as jp
from statecatcher_tpu.ops.rnnt import blank_emit_from_log_probs, rnnt_loss_fused
from statecatcher_tpu.train.step import init_train_state as j_init_state
from statecatcher_tpu.train.step import make_segment_scan_step as j_scan_step
from statecatcher_tpu_torch.config import Config
from statecatcher_tpu_torch.convert import torch_to_flax
from statecatcher_tpu_torch.models.asr import init_carry
from statecatcher_tpu_torch.models.speech import build_speech_model
from statecatcher_tpu_torch.ops import rnnt_band as rb
from statecatcher_tpu_torch.ops.rnnt_joint import joint_blank_emit, rnnt_loss_pallas
from statecatcher_tpu_torch.testing import randomize_
from statecatcher_tpu_torch.train.step import init_train_state, make_segment_scan_step
from test_torch_cuda import assert_grad_close, single_torch_thread  # noqa: F401
from test_torch_train_step import _jax_features

pytestmark = pytest.mark.usefixtures("single_torch_thread")

WIDE = [200, 640]


@pytest.fixture
def _band_interpret():
    jrb._INTERPRET[0] = True
    yield
    jrb._INTERPRET[0] = False


def _problem(seed, J, B=2, T=19, U=7, V=40, blank_id=7):
    rng = np.random.default_rng(seed)
    enc = (rng.standard_normal((B, T, J)) * 0.4).astype(np.float32)
    pred = (rng.standard_normal((B, U + 1, J)) * 0.4).astype(np.float32)
    k = (rng.standard_normal((J, V)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(V) * 0.1).astype(np.float32)
    labels = rng.integers(1, V, (B, U)).astype(np.int32)
    labels[labels == blank_id] = blank_id + 1
    return enc, pred, k, b, labels


@pytest.mark.parametrize("J", WIDE)
def test_wide_joint_forward_matches_jax_interpret(J):
    enc, pred, k, b, labels = _problem(J, J)
    with pltpu.force_tpu_interpret_mode():
        jb_, je_ = jax.jit(lambda *xs: jp.joint_blank_emit(*xs, jnp.asarray(labels), blank_id=7))(
            *map(jnp.asarray, (enc, pred, k, b)))
    got = joint_blank_emit(*map(torch.from_numpy, (enc, pred, k, b, labels)), blank_id=7)
    for name, g, w in zip(("blank", "emit"), got, (jb_, je_)):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("J", WIDE)
def test_wide_banded_forward_matches_jax_interpret(_band_interpret, J):
    """Band 4 in time blocks of 8 at U = 20: a window that prunes, with a
    short row."""
    enc, pred, k, b, labels = _problem(J + 1, J, B=3, T=40, U=20)
    t_lens, u_lens = np.array([40, 33, 26], np.int32), np.array([20, 17, 9], np.int32)
    Wp = rb.band_width(4, 21, 8)
    o = np.asarray(jrb.band_offsets(jnp.asarray(t_lens), jnp.asarray(u_lens), 40, 24, Wp, 8))
    jb_, je_ = jrb.joint_blank_emit_banded(*map(jnp.asarray, (enc, pred, k, b, labels, o)), Wp,
                                           blank_id=7, time_block=8)
    got = rb.joint_blank_emit_banded(*map(torch.from_numpy, (enc, pred, k, b, labels, o)), Wp,
                                     blank_id=7, time_block=8)
    for name, g, w in zip(("blank", "emit"), got, (jb_, je_)):
        assert g.dtype == torch.float32 and g.shape == (3, 40, Wp), name
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def _xla_joint(enc, pred, k, b, labels, blank_id):
    logits = jnp.tanh(enc[:, :, None, :] + pred[:, None, :, :]) @ k + b
    return blank_emit_from_log_probs(jax.nn.log_softmax(logits, axis=-1), labels, blank_id)


@pytest.mark.parametrize("J", WIDE)
def test_wide_joint_grads_match_jax_xla(J):
    """The weighted sums of blank and emit: the port's plain K6b against
    the gradient of JAX's XLA joint."""
    enc, pred, k, b, labels = _problem(J + 2, J)
    rng = np.random.default_rng(J)
    w_blank = rng.uniform(0.5, 1.5, (2, 19, 8)).astype(np.float32)
    w_emit = rng.uniform(0.5, 1.5, (2, 19, 7)).astype(np.float32)

    def f(*xs):
        blank, emit = _xla_joint(*xs, jnp.asarray(labels), 7)
        return jnp.sum(blank * w_blank) + jnp.sum(emit * w_emit)

    jg = jax.jit(jax.grad(f, argnums=(0, 1, 2, 3)))(*map(jnp.asarray, (enc, pred, k, b)))
    xs = [torch.from_numpy(x).requires_grad_() for x in (enc, pred, k, b)]
    blank, emit = joint_blank_emit(*xs, torch.from_numpy(labels), blank_id=7)
    weighted = (blank * torch.from_numpy(w_blank)).sum() + (emit * torch.from_numpy(w_emit)).sum()
    weighted.backward()
    for name, x, g in zip(("enc", "pred", "kernel", "bias"), xs, jg):
        assert_grad_close(x.grad.numpy(), np.asarray(g), name, rtol=2e-4, scale_tol=2e-5)


@pytest.mark.parametrize("J", WIDE)
@pytest.mark.parametrize("loss", ["exact", "full band"])
def test_wide_losses_match_jax_xla(J, loss):
    """The exact loss (K6 + K7's plain versions) and the banded loss at a
    band that holds every position (K8 + the banded lattice), which equals
    it, against JAX's XLA ``rnnt_loss_fused``, with a row_valid=False row."""
    enc, pred, k, b, labels = _problem(J + 3, J, B=3, T=24, U=10, blank_id=0)
    t_lens, u_lens = np.array([24, 19, 15], np.int32), np.array([10, 7, 4], np.int32)
    row_valid = np.array([True, True, False])

    def f(*xs):
        return rnnt_loss_fused(*xs, *map(jnp.asarray, (labels, t_lens, u_lens)), blank_id=0,
                               row_valid=jnp.asarray(row_valid))

    jl, jg = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2, 3)))(
        *map(jnp.asarray, (enc, pred, k, b)))
    xs = [torch.from_numpy(x).requires_grad_() for x in (enc, pred, k, b)]
    rest = (*map(torch.from_numpy, (labels, t_lens, u_lens)),)
    if loss == "exact":
        got = rnnt_loss_pallas(*xs, *rest, blank_id=0, row_valid=torch.from_numpy(row_valid))
    else:
        got = rb.rnnt_loss_banded(*xs, *rest, blank_id=0, row_valid=torch.from_numpy(row_valid),
                                  band=11, time_block=8)
    got.backward()
    np.testing.assert_allclose(got.item(), float(jl), rtol=1e-5)
    for name, x, g in zip(("enc", "pred", "kernel", "bias"), xs, jg):
        assert_grad_close(x.grad.numpy(), np.asarray(g), name, rtol=2e-4, scale_tol=2e-5)
    assert not xs[0].grad[2].any()                               # the invalid row


K, B, S, V = 2, 3, 4000, 24
LR = 1e-5
WIDE_ARGS = ["--model.encoder", "lucyrnn", "--model.hidden_size", "16", "--model.num_layers", "2",
             "--model.vocab_size", str(V), "--model.lucyrnn.kernel_impl", "xla-scan",
             "--train.optim.lr", str(LR), "--train.mode", "rnnt",
             "--model.rnnt_pred_emb_dim", "640", "--model.rnnt_joiner_dim", "640"]


def _group(seed, U):
    rng = np.random.default_rng(seed)
    audio = rng.uniform(-0.3, 0.3, (K, B, S)).astype(np.float32)
    lens = rng.integers(S // 2, S + 1, (K, B)).astype(np.int32)
    lens[:, 0] = S
    mask = np.arange(S)[None, None, :] < lens[..., None]
    tokens = rng.integers(1, V, (K, B, U)).astype(np.int32)
    tok_lens = rng.integers(U // 4, U + 1, (K, B)).astype(np.int32)
    tok_lens[0, 0] = U
    row_valid = np.ones((K, B), bool)
    row_valid[:, 2] = False
    return audio, mask, tokens, tok_lens, row_valid, np.ones((K,), bool)


@pytest.mark.parametrize("loss", ["exact", "banded"])
def test_wide_joiner_step_matches_jax_in_lockstep(_band_interpret, loss, monkeypatch):
    """One group of K=2 carried segments at joiner 640: the port's step
    with ``rnnt_impl`` "pallas" (on the CPU the plain versions of K6/K7 at
    U = 24, exact; of K8 and the banded lattice at U = 64, band 32) against
    JAX's step (``rnnt_impl`` "auto", the XLA ``rnnt_loss_fused``, for the
    exact loss; "pallas", its banded kernels in interpret mode, for the
    banded one).  Per segment the loss and per-utterance NLL to rtol 2e-5
    and the grad norm to 2e-4; after the group every parameter to rtol 1e-5
    plus 2·lr·K (Adam moves a component whose gradient is near zero by ±lr
    on the sign of its round-off) and the carry to 1e-4 of its scale."""
    U = 24 if loss == "exact" else 64
    impl = "auto" if loss == "exact" else "pallas"
    cfg = Config().apply_overrides(WIDE_ARGS + ["--train.rnnt_impl", "pallas"])
    jcfg = JConfig().apply_overrides(WIDE_ARGS + ["--train.rnnt_impl", impl])
    assert step_module.resolve_rnnt_band(cfg.train.rnnt_band, U) == (0 if loss == "exact" else 32)
    model = build_speech_model(cfg.model, 80, "rnnt", device="cpu",
                               generator=torch.Generator().manual_seed(0))
    randomize_(model, 1, gate_weight_scale=0.1)
    params = torch_to_flax(model.state_dict(), cfg.model)
    assert params["params"]["joiner"]["enc_proj"]["kernel"].shape[-1] == 640
    group = _group(23, U)

    jmodel = j_build_speech(jcfg.model, 80, "rnnt")
    jstate = jax.jit(lambda rng: j_init_state(jmodel, jcfg, rng, 80, 8))(jax.random.PRNGKey(0))
    jstate = jstate.replace(params=jax.tree.map(
        lambda tmpl, p: jax.numpy.asarray(p, tmpl.dtype), jstate.params, params))
    jstate, jcarry, jouts = j_scan_step(jmodel, jcfg, blank_id=0)(
        jstate, j_init_carry(jcfg.model, B), *map(jax.numpy.asarray, group))

    monkeypatch.setattr(step_module, "compute_features", _jax_features(jcfg.frontend))
    state = init_train_state(model, cfg)
    step = make_segment_scan_step(model, cfg, blank_id=0)
    state, carry, outs = step(state, init_carry(cfg.model, B, device="cpu"),
                              *map(torch.from_numpy, group[:5]), group[5])

    for k, rtol in (("loss", 2e-5), ("per_loss", 2e-5), ("grad_norm", 2e-4)):
        np.testing.assert_allclose(getattr(outs, k).numpy(), np.asarray(getattr(jouts, k)),
                                   rtol=rtol, atol=0, err_msg=k)
    assert (outs.per_loss.numpy()[:, :2] > 0).all()
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_leaves_with_path(torch_to_flax(model.state_dict(), cfg.model)),
            jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, jstate.params))):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=2 * LR * K,
                                   err_msg=jax.tree_util.keystr(path))
    for k in ("h", "s"):
        want = np.asarray(jcarry[k])
        np.testing.assert_allclose(carry[k].numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(), err_msg=f"carry {k}")
