"""CTC loss of the PyTorch port (statecatcher_tpu_torch/ops/ctc.py and
ops/ctc_lattice.py): the plain versions of the α and β kernels (K3, K4)
against the JAX TPU kernels ``_alpha_all``/``_beta_all`` run in Pallas
interpret mode, and ``ctc_loss_per_example`` values and gradients against the
JAX package's ``impl="lattice"`` and ``impl="pallas"``.

The problems cover repeated labels, ``label_len = 0``, ``in_len < T``, a row
that cannot be aligned (``zero_infinity``) and a label sequence with
S = 2U+1 > 1024 states at a tiny B and T.

Tolerances: α and β are compared where they are finite lattice values
(above −1e29; dead states sit at about −1e30 on both sides) to 2e-5
absolute, f32 round-off of a log-sum-exp chain over T steps.  The lattice
path is compared in float64 on both sides (JAX with x64), to 1e-10.  The
pallas path is float32 on both sides: NLL to rtol 2e-6; gradients (γ
posteriors, bounded by 1) to 2e-6 absolute plus 1e-3 relative, because
γ = exp(α + β − emit − log Z) subtracts log-values as large as |log Z| ≈ 2e3
at T = 520, whose f32 spacing is 1.2e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from statecatcher_tpu.ops import ctc as jctc
from statecatcher_tpu.ops import ctc_pallas as jcp
from statecatcher_tpu_torch.ops.ctc import ctc_loss_per_example, ctc_nll_lattice
from statecatcher_tpu_torch.ops.ctc_lattice import (
    ctc_alpha,
    ctc_alpha_ref,
    ctc_beta,
    ctc_beta_ref,
    emit_log_probs,
    expand_labels,
    skip_allowed,
)
from test_torch_cuda import single_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_torch_thread")


def _problem(seed, B=4, T=20, U=6, V=12):
    """Logits and labels with repeats, row 1 with label_len 0, row 2 with
    in_len < T, row 3 unalignable (more labels than frames)."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, T, V)) * 2.0
    # no neighbours alike (so U labels fit in U + 1 frames) but one repeat
    steps = rng.integers(1, V - 1, size=(B, U))
    labels = (np.cumsum(steps, axis=1) % (V - 1) + 1).astype(np.int32)
    if U >= 2:
        labels[0, 1] = labels[0, 0]
    in_lens = np.full(B, T, np.int32)
    label_lens = np.full(B, U, np.int32)
    if B >= 4:
        label_lens[1] = 0
        labels[1] = 0                                        # padded with blank, as the loop pads
        in_lens[2] = T - 7
        label_lens[2] = max(U - 2, 0)
        in_lens[3] = 3                                       # 3 frames, U labels: unalignable
    return logits, labels, in_lens, label_lens


def _jax_emit(logits, labels):
    lp = jax.nn.log_softmax(jnp.asarray(logits, jnp.float32), -1)
    ext, allow_skip, emit, _ = jcp._prep(lp, None, jnp.asarray(labels), 0)
    return np.asarray(emit), np.asarray(allow_skip)


def _finite_close(got, want, atol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    live = want > -1e29
    assert np.array_equal(live, got > -1e29)
    np.testing.assert_allclose(got[live], want[live], rtol=0, atol=atol)


@pytest.mark.parametrize("T,U", [(20, 6), (33, 1), (9, 513)])
def test_alpha_beta_plain_match_jax_interpret(T, U):
    logits, labels, in_lens, label_lens = _problem(T + U, T=T, U=U)
    emit, allow_skip = _jax_emit(logits, labels)
    with pltpu.force_tpu_interpret_mode():
        ja = jcp._alpha_all(jnp.asarray(emit), jnp.asarray(allow_skip), jnp.asarray(in_lens))
        jb = jcp._beta_all(jnp.asarray(emit), jnp.asarray(allow_skip), jnp.asarray(in_lens),
                           jnp.asarray(label_lens))
    te, ts = torch.from_numpy(emit), torch.from_numpy(allow_skip)
    ti, tl = torch.from_numpy(in_lens), torch.from_numpy(label_lens)
    a, b = ctc_alpha_ref(te, ts, ti), ctc_beta_ref(te, ts, ti, tl)
    assert a.dtype == b.dtype == torch.float32 and a.shape == emit.shape
    _finite_close(a.numpy(), ja, 2e-5)
    _finite_close(b.numpy(), jb, 2e-5)
    # the wrappers run the plain versions on the CPU and launch nothing
    n = (ctc_alpha.launches, ctc_beta.launches)
    assert torch.equal(ctc_alpha(te, ts, ti), a) and torch.equal(ctc_beta(te, ts, ti, tl), b)
    assert (ctc_alpha.launches, ctc_beta.launches) == n


def test_emission_lookup_and_skip_rule_match_jax():
    logits, labels, _, _ = _problem(3)
    emit, allow_skip = _jax_emit(logits, labels)
    lp = torch.log_softmax(torch.from_numpy(logits).float(), -1)
    ext = expand_labels(torch.from_numpy(labels), 0)
    np.testing.assert_array_equal(ext.numpy(), np.asarray(jctc._expand_labels(jnp.asarray(labels), 0)))
    np.testing.assert_array_equal(skip_allowed(ext, 0).numpy(), allow_skip)
    np.testing.assert_allclose(emit_log_probs(lp, ext).numpy(), emit, rtol=0, atol=1e-6)


def _check_unalignable(per, grad, U):
    """Row 3 cannot be aligned: its NLL is about 1e30.  zero_infinity zeroes
    it when 1e30 / U ≥ 1e29; at U = 512 it stays, at about 2e27, in both
    packages (the reference's threshold)."""
    if U < 10:
        assert per[3] == 0.0 and not grad[3].any()
    else:
        assert 1e27 < per[3] < 1e29


def _loss_and_grad_jax(logits, labels, in_lens, label_lens, impl, w):
    def f(x):
        per = jctc.ctc_loss_per_example(x, jnp.asarray(in_lens), jnp.asarray(labels),
                                        jnp.asarray(label_lens), impl=impl)
        return jnp.sum(per * w), per

    (_, per), g = jax.jit(jax.value_and_grad(f, has_aux=True))(jnp.asarray(logits))
    return np.asarray(per), np.asarray(g)


def _loss_and_grad_torch(logits, labels, in_lens, label_lens, impl, w):
    x = torch.from_numpy(logits).requires_grad_()
    per = ctc_loss_per_example(x, torch.from_numpy(in_lens), torch.from_numpy(labels),
                               torch.from_numpy(label_lens), impl=impl)
    (per * torch.from_numpy(w)).sum().backward()
    return per.detach().numpy(), x.grad.numpy()


@pytest.mark.parametrize("T,U", [(20, 6), (520, 512)])
def test_lattice_loss_and_grad_match_jax_f64(T, U):
    logits, labels, in_lens, label_lens = _problem(7 + U, B=4, T=T, U=U)
    w = np.random.default_rng(8).uniform(0.5, 1.5, 4)
    with jax.enable_x64(True):
        jper, jg = _loss_and_grad_jax(logits, labels, in_lens, label_lens, "lattice", w)
    tper, tg = _loss_and_grad_torch(logits, labels, in_lens, label_lens, "lattice", w)
    assert tper.dtype == np.float64 and 0 < tper[0] < 1e4 and 0 < tper[1] < 1e4
    _check_unalignable(tper, tg, U)
    np.testing.assert_allclose(tper, jper, rtol=1e-10, atol=1e-12)
    # the gradient of an unalignable row that zero_infinity keeps is the
    # round-off of log-sums near -1e30 on either side: only held finite
    rows = slice(None) if U < 10 else slice(0, 3)
    assert np.isfinite(tg).all()
    np.testing.assert_allclose(tg[rows], jg[rows], rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("T,U", [(20, 6), (520, 512)])
def test_pallas_loss_and_grad_match_jax_interpret(T, U):
    logits, labels, in_lens, label_lens = _problem(9 + U, B=4, T=T, U=U)
    logits = logits.astype(np.float32)
    w = np.random.default_rng(10).uniform(0.5, 1.5, 4).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        jper, jg = _loss_and_grad_jax(logits, labels, in_lens, label_lens, "pallas", w)
    tper, tg = _loss_and_grad_torch(logits, labels, in_lens, label_lens, "pallas", w)
    assert tper.dtype == tg.dtype == np.float32
    _check_unalignable(tper, tg, U)
    np.testing.assert_allclose(tper, jper, rtol=2e-6, atol=1e-6)
    np.testing.assert_allclose(tg, jg, rtol=1e-3, atol=2e-6)


def test_auto_and_optax_take_the_lattice_on_cpu():
    logits, labels, in_lens, label_lens = _problem(11)
    args = [torch.from_numpy(x) for x in (logits, in_lens, labels, label_lens)]
    want = ctc_loss_per_example(*args, impl="lattice")
    for impl in ("auto", "optax"):
        assert torch.equal(ctc_loss_per_example(*args, impl=impl), want)
    lp = torch.log_softmax(args[0], -1)
    nll = ctc_nll_lattice(lp, args[1], args[2], args[3])
    np.testing.assert_allclose((nll / torch.clamp(args[3], min=1))[:3].numpy(), want[:3].numpy(),
                               rtol=1e-15)
    with pytest.raises(ValueError):
        ctc_loss_per_example(*args, impl="bogus")


def test_pallas_matches_lattice_in_f32():
    """The two port paths compute the same loss: K3/K4's plain versions
    (f32) and the autograd lattice (in f32 here)."""
    logits, labels, in_lens, label_lens = _problem(12)
    w = np.ones(4, np.float32)
    a = _loss_and_grad_torch(logits.astype(np.float32), labels, in_lens, label_lens, "pallas", w)
    b = _loss_and_grad_torch(logits.astype(np.float32), labels, in_lens, label_lens, "lattice", w)
    np.testing.assert_allclose(a[0], b[0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(a[1], b[1], rtol=0, atol=1e-5)
