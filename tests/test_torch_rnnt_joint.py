"""The plain versions of the fused RNN-T joint kernels of the PyTorch port
(K6, ``ops/rnnt_joint.py``) against the JAX TPU kernels run in Pallas
interpret mode (as tests/test_rnnt_pallas.py runs them on the CPU):
``joint_blank_emit`` (its plain forward and backward on the CPU) against JAX
``joint_blank_emit``, values and the gradients of a weighted sum to enc_p,
pred_p, join_kernel and join_bias, with blank_id 0 and 7, and the whole
``rnnt_loss_pallas`` with a row_valid=False row.  Float32, with the JAX
tests' tolerances: 1e-5, gradients 2e-4 relative plus 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from statecatcher_tpu.ops import rnnt_pallas as jp
from statecatcher_tpu_torch.ops.rnnt_joint import joint_blank_emit, rnnt_loss_pallas
from test_torch_cuda import single_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_torch_thread")


def _joint_problem(seed, B=3, T=23, U=11, J=40, V=150, blank_id=0):
    rng = np.random.default_rng(seed)
    enc = rng.standard_normal((B, T, J)).astype(np.float32)
    pred = rng.standard_normal((B, U + 1, J)).astype(np.float32)
    k = (rng.standard_normal((J, V)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(V) * 0.1).astype(np.float32)
    labels = rng.integers(1, V, (B, U)).astype(np.int32)
    labels[labels == blank_id] = blank_id + 1
    w_blank = rng.uniform(0.5, 1.5, (B, T, U + 1)).astype(np.float32)
    w_emit = rng.uniform(0.5, 1.5, (B, T, U)).astype(np.float32)
    return enc, pred, k, b, labels, w_blank, w_emit


@pytest.mark.parametrize("blank_id", [0, 7])
def test_joint_plain_matches_jax_interpret(blank_id):
    enc, pred, k, b, labels, w_blank, w_emit = _joint_problem(1 + blank_id, blank_id=blank_id)

    def f(*xs):
        blank, emit = jp.joint_blank_emit(*xs, jnp.asarray(labels), blank_id=blank_id)
        return jnp.sum(blank * w_blank) + jnp.sum(emit * w_emit), (blank, emit)

    with pltpu.force_tpu_interpret_mode():
        (_, (jb, je)), jg = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2, 3), has_aux=True))(
            *map(jnp.asarray, (enc, pred, k, b)))
    xs = [torch.from_numpy(x).requires_grad_() for x in (enc, pred, k, b)]
    blank, emit = joint_blank_emit(*xs, torch.from_numpy(labels), blank_id=blank_id)
    assert blank.dtype == emit.dtype == torch.float32 and emit.shape == labels.shape[:1] + (23, 11)
    ((blank * torch.from_numpy(w_blank)).sum() + (emit * torch.from_numpy(w_emit)).sum()).backward()
    np.testing.assert_allclose(blank.detach().numpy(), jb, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(emit.detach().numpy(), je, rtol=1e-5, atol=1e-5)
    for name, x, g in zip(("enc", "pred", "kernel", "bias"), xs, jg):
        np.testing.assert_allclose(x.grad.numpy(), g, rtol=2e-4, atol=2e-5, err_msg=name)


def test_loss_plain_matches_jax_interpret_with_row_valid():
    enc, pred, k, b, labels, _, _ = _joint_problem(9)
    t_lens = np.array([23, 17, 14], np.int32)
    u_lens = np.array([11, 0, 6], np.int32)
    row_valid = np.array([True, True, False])

    def f(*xs):
        return jp.rnnt_loss_pallas(*xs, jnp.asarray(labels), jnp.asarray(t_lens),
                                   jnp.asarray(u_lens), row_valid=jnp.asarray(row_valid))

    with pltpu.force_tpu_interpret_mode():
        jl, jg = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2, 3)))(
            *map(jnp.asarray, (enc, pred, k, b)))
    xs = [torch.from_numpy(x).requires_grad_() for x in (enc, pred, k, b)]
    loss = rnnt_loss_pallas(*xs, *map(torch.from_numpy, (labels, t_lens, u_lens)),
                            row_valid=torch.from_numpy(row_valid))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    for name, x, g in zip(("enc", "pred", "kernel", "bias"), xs, jg):
        np.testing.assert_allclose(x.grad.numpy(), g, rtol=2e-4, atol=2e-5, err_msg=name)
    assert not xs[0].grad[2].any()
