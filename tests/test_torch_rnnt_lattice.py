"""The plain versions of the RNN-T lattice kernels of the PyTorch port
(K7, ``ops/rnnt_lattice.py``) against the JAX TPU kernels run in Pallas
interpret mode (as tests/test_rnnt_dp_pallas.py runs them on the CPU): α
and β against ``_alpha_all``/``_beta_all`` (live values to 2e-5 plus 2e-6
of their size), and ``rnnt_nll_dp_pallas``'s NLL and occupancy gradients
against the JAX one (NLL 1e-5, gradients 1e-4 relative plus 1e-6), with a
u_len = 0 row, U = 0, and T = 160 (longer than one of the TPU kernel's
128-frame time chunks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from statecatcher_tpu.ops import rnnt_dp_pallas as jdp
from statecatcher_tpu_torch.ops.rnnt_lattice import (
    rnnt_alpha_ref,
    rnnt_beta_ref,
    rnnt_nll_dp_pallas,
)
from test_torch_cuda import single_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_torch_thread")


def _lattice_problem(seed, B=4, T=37, U=13):
    rng = np.random.default_rng(seed)
    blank = (rng.standard_normal((B, T, U + 1)) - 1.5).astype(np.float32)
    emit = (rng.standard_normal((B, T, U)) - 1.5).astype(np.float32)
    t_lens = rng.integers(U + 2, T + 1, B).astype(np.int32)
    u_lens = rng.integers(0, U + 1, B).astype(np.int32)
    u_lens[0] = 0
    t_lens[-1] = T
    return blank, emit, t_lens, u_lens


def _live_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    live = want > -1e29
    assert np.array_equal(live, got > -1e29)
    np.testing.assert_allclose(got[live], want[live], rtol=2e-6, atol=2e-5)


@pytest.mark.parametrize("B,T,U", [(4, 37, 13), (2, 160, 7), (2, 9, 0)])
def test_lattice_plain_matches_jax_interpret(B, T, U):
    blank, emit, t_lens, u_lens = _lattice_problem(T + U, B, T, U)
    w = np.random.default_rng(3).uniform(0.5, 2.0, B).astype(np.float32)
    jt, ju = jnp.asarray(t_lens), jnp.asarray(u_lens)

    @jax.jit
    def ref(bl, em):
        """α, β, the weighted NLL and its gradients: each kernel once."""
        nll, res = jdp._nll_fwd(bl, em, jt, ju)
        return res[4], jdp._beta_all(bl, em, jt, ju), jnp.sum(nll * w), jdp._nll_bwd(res, w)[:2]

    with pltpu.force_tpu_interpret_mode():
        ja, jb, jl, jg = ref(jnp.asarray(blank), jnp.asarray(emit))
    tb, te, tt, tu = map(torch.from_numpy, (blank, emit, t_lens, u_lens))
    _live_close(rnnt_alpha_ref(tb, te, tt).numpy(), ja)
    _live_close(rnnt_beta_ref(tb, te, tt, tu).numpy(), jb)
    xb, xe = tb.clone().requires_grad_(), te.clone().requires_grad_()
    nll = rnnt_nll_dp_pallas(xb, xe, tt, tu)
    (nll * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose((nll.detach() * torch.from_numpy(w)).sum().item(), float(jl),
                               rtol=1e-5)
    for name, x, g in zip(("g_blank", "g_emit"), (xb, xe), jg):
        np.testing.assert_allclose(x.grad.numpy(), g, rtol=1e-4, atol=1e-6, err_msg=name)
    # each active frame consumes exactly one blank: occupancies sum to 1 over u
    occ = -xb.grad.numpy() / w[:, None, None]
    for r in range(B):
        np.testing.assert_allclose(occ[r, :t_lens[r]].sum(1), 1.0, atol=5e-4)
        assert not occ[r, t_lens[r]:].any()


def test_lattice_plain_frames_match_jax_interpret():
    """The plain versions in the frame order (the scan route's, and the TPU
    kernel's) against ``_alpha_all``/``_beta_all``."""
    blank, emit, t_lens, u_lens = _lattice_problem(11, 4, 37, 13)
    with pltpu.force_tpu_interpret_mode():
        ja = jdp._alpha_all(*map(jnp.asarray, (blank, emit, t_lens)))
        jb = jdp._beta_all(*map(jnp.asarray, (blank, emit, t_lens, u_lens)))
    tb, te, tt, tu = map(torch.from_numpy, (blank, emit, t_lens, u_lens))
    _live_close(rnnt_alpha_ref(tb, te, tt, order="frames").numpy(), ja)
    _live_close(rnnt_beta_ref(tb, te, tt, tu, order="frames").numpy(), jb)
