"""The K10 path of the PyTorch port (statecatcher_tpu_torch/ops/
mlstm_pallas.py: ``mlstm_chunkwise_pallas``, whose plain forward is
``mlstm_chunkwise`` and whose backward is autograd of it on the saved
inputs) against the JAX package's XLA ``mlstm_chunkwise`` and ``jax.vjp`` of
it, at small shapes (2 heads, dqk = dv = 16, chunk 16), ragged T and a
nonzero carry: forward rtol 2e-4, atol 2e-5; gradients rtol 5e-3, atol 5e-4
(the tolerances of tests/test_mlstm_fused.py).  No JAX gradient runs through
a Pallas kernel here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from statecatcher_tpu.models.xlstm import mlstm_chunkwise as j_chunkwise
from statecatcher_tpu_torch.ops.mlstm_pallas import mlstm_chunkwise_pallas, mlstm_pallas_fwd
from test_torch_cuda import single_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_torch_thread")

NAMES = ["q", "k", "v", "i_raw", "f_raw", "C0", "n0", "m0"]


@pytest.mark.parametrize("T", [32, 45])
def test_pallas_path_and_grads_match_jax(T):
    B, H, dqk, dv = 2, 2, 16, 16
    rng = np.random.default_rng(T)
    r = lambda *s: rng.standard_normal(s).astype(np.float32) * 0.5
    xs = [r(B, H, T, dqk), r(B, H, T, dqk), r(B, H, T, dv), 2.0 * r(B, H, T),
          2.0 * r(B, H, T) + 1.0, 0.1 * r(B, H, dqk, dv), np.abs(0.1 * r(B, H, dqk)),
          0.1 * r(B, H)]
    cots = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, T, dv), (B, H, dqk, dv), (B, H, dqk), (B, H))]
    want, vjp = jax.vjp(lambda *a: j_chunkwise(*a, 16), *map(jnp.asarray, xs))
    jgrads = vjp(tuple(map(jnp.asarray, cots)))

    n = mlstm_pallas_fwd.launches
    ts = [torch.from_numpy(x).requires_grad_() for x in xs]
    got = mlstm_chunkwise_pallas(*ts, 16)
    assert mlstm_pallas_fwd.launches == n                 # the CPU runs the plain version
    for name, a, b in zip(("h", "C_T", "n_T", "m_T"), got, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=2e-4, atol=2e-5,
                                   err_msg=name)
    torch.autograd.backward(got, [torch.from_numpy(c) for c in cots])
    for name, x, g in zip(NAMES, ts, jgrads):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(g), rtol=5e-3, atol=5e-4,
                                   err_msg=f"d_{name}")
