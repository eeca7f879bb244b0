"""The plain versions of K9a/K9b (statecatcher_tpu_torch/ops/mlstm_fused.py)
against the JAX package, at small shapes (dqk = dv = 16, 2 heads):

  * the forward against JAX's ``mlstm_fused`` with its Pallas forward kernel
    in interpret mode (forward only, as tests/test_mlstm_fused.py runs it),
    at T = 32 and 45 (ragged) with chunk 16 and a nonzero carry: rtol 2e-4,
    atol 2e-5 (float32 sums in other orders through the exponential gating;
    the tolerances of that file);
  * ``mlstm_chunk_bwd_ref``, the chunk step's adjoint written out, against
    ``torch.autograd`` of ``mlstm_chunk_step`` in float64, also where the
    maxima tie: rtol 1e-9, atol 1e-12 (the same function, two operation
    orders);
  * the gradients of ``mlstm_fused`` (q, k, v, the raw gates, C0, n0, m0)
    against ``jax.vjp`` of the JAX package's pure-XLA ``mlstm_chunkwise``:
    rtol 5e-3, atol 5e-4, and the forward rtol 2e-4, atol 2e-5, as
    tests/test_mlstm_fused.py holds its fused kernel to that form.

No JAX gradient runs through a Pallas kernel here.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import statecatcher_tpu.ops.mlstm_fused as jmf
from statecatcher_tpu.models.xlstm import mlstm_chunkwise as j_chunkwise
from statecatcher_tpu_torch.ops import mlstm_fused as mf
from test_torch_cuda import single_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_torch_thread")

B, H, DQK, DV = 2, 2, 16, 16
NAMES = ["q", "k", "v", "i_raw", "f_raw", "C0", "n0", "m0"]


def _data(seed, T):
    """Lane-major inputs as the JAX package's tests make them."""
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s).astype(np.float32) * 0.5
    return dict(q=r(B, T, H * DQK), k=r(B, T, H * DQK), v=r(B, T, H * DV),
                i_raw=r(B, T, H) * 2.0, f_raw=r(B, T, H) * 2.0 + 1.0,
                C0=r(B, H, DQK, DV) * 0.1, n0=np.abs(r(B, H, DQK)) * 0.1, m0=r(B, H) * 0.1)


def _torch_fused(d, chunk, requires_grad=False):
    xs = [torch.from_numpy(d[n]).requires_grad_(requires_grad) for n in NAMES]
    return xs, mf.mlstm_fused(*xs, chunk)


@pytest.mark.parametrize("T", [32, 45])
def test_forward_matches_interpret_mode_kernel(T, monkeypatch):
    monkeypatch.setattr(jmf, "_fused_fwd_impl",
                        functools.partial(jmf._fused_fwd_impl.__wrapped__, interpret=True))
    d = _data(T, T)
    want = jmf.mlstm_fused(*(jnp.asarray(d[n]) for n in NAMES), 16)
    _, got = _torch_fused(d, 16)
    for name, a, b in zip(("h", "C_T", "n_T", "m_T"), got, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=2e-4, atol=2e-5,
                                   err_msg=name)


@pytest.mark.parametrize("ties", [False, True])
def test_chunk_adjoint_matches_autograd(ties):
    """With ``ties`` the log-forget is 0 and the input gate constant, so
    every a_s is equal (the running max ties all along) and m0 equals it
    (max(m, R) and m' tie too): each tied branch gets an equal share, as
    ``torch.amax``/``torch.maximum`` (and JAX) send it."""
    rng = np.random.default_rng(9)
    Bb, L = 3, 8
    r = lambda *s, sc=0.5: torch.from_numpy(rng.standard_normal(s) * sc)
    ins = [r(Bb, H, L, DQK), r(Bb, H, L, DQK), r(Bb, H, L, DV), r(Bb, H, L, sc=2.0),
           torch.nn.functional.logsigmoid(r(Bb, H, L, sc=2.0) + 1.0), r(Bb, H, DQK, DV, sc=0.1),
           r(Bb, H, DQK, sc=0.1).abs(), r(Bb, H, sc=0.1)]
    if ties:
        ins[3] = torch.full((Bb, H, L), -0.3, dtype=torch.float64)
        ins[4] = torch.zeros((Bb, H, L), dtype=torch.float64)
        ins[7] = torch.full((Bb, H), -0.3, dtype=torch.float64)
    ins = [x.requires_grad_() for x in ins]
    inv = DQK ** -0.5
    outs = mf.mlstm_chunk_step(*ins, inv)
    cots = [r(*o.shape) for o in outs]
    want = torch.autograd.grad(sum((o * c).sum() for o, c in zip(outs, cots)), ins)
    got = mf.mlstm_chunk_bwd_ref(*(x.detach() for x in ins), *cots, inv)
    for name, a, b in zip(("q", "k", "v", "ic", "logf", "C", "n", "m"), got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9, atol=1e-12, err_msg=name)


def _jax_chunkwise(args, chunk):
    """JAX's XLA chunkwise form on the lane-major layout (the head
    transposes of tests/test_mlstm_fused.py)."""
    q, k, v, i_raw, f_raw, C0, n0, m0 = args
    T = q.shape[1]
    tr = lambda x, dd: x.reshape(B, T, H, dd).transpose(0, 2, 1, 3)
    h, C_T, n_T, m_T = j_chunkwise(tr(q, DQK), tr(k, DQK), tr(v, DV), i_raw.transpose(0, 2, 1),
                                   f_raw.transpose(0, 2, 1), C0, n0, m0, chunk)
    return h.transpose(0, 2, 1, 3).reshape(B, T, H * DV), C_T, n_T, m_T


@pytest.mark.parametrize("T", [32, 45])
def test_gradients_match_jax_vjp_of_chunkwise(T):
    d = _data(100 + T, T)
    rng = np.random.default_rng(T)
    cots = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, T, H * DV), (B, H, DQK, DV), (B, H, DQK), (B, H))]
    want, vjp = jax.vjp(lambda *a: _jax_chunkwise(a, 16), *(jnp.asarray(d[n]) for n in NAMES))
    jgrads = vjp(tuple(jnp.asarray(c) for c in cots))
    xs, got = _torch_fused(d, 16, requires_grad=True)
    for name, a, b in zip(("h", "C_T", "n_T", "m_T"), got, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=2e-4, atol=2e-5,
                                   err_msg=name)
    torch.autograd.backward(got, [torch.from_numpy(c) for c in cots])
    for name, x, g in zip(NAMES, xs, jgrads):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(g), rtol=5e-3, atol=5e-4,
                                   err_msg=f"d_{name}")


# (B, T, H, dqk, dv, chunk) above 256: chunk 512
# over two chunks with T ragged, and dqk 512 at one head and short T
WIDE = [(1, 600, 2, 8, 8, 512), (1, 40, 1, 512, 16, 16)]


@pytest.mark.parametrize("B,T,H,dqk,dv,chunk", WIDE)
def test_wide_shapes_match_jax(B, T, H, dqk, dv, chunk, monkeypatch):
    """The port's forward against JAX's K9a in interpret mode (rtol 2e-4, atol
    2e-5), and its gradients against ``jax.vjp`` of JAX's XLA
    ``mlstm_chunkwise`` (rtol 5e-3, atol 5e-4), at chunk 512 and at dqk 512."""
    rng = np.random.default_rng(T + dqk)
    r = lambda *s: rng.standard_normal(s).astype(np.float32) * 0.5
    d = [r(B, T, H * dqk), r(B, T, H * dqk), r(B, T, H * dv), r(B, T, H) * 2.0,
         r(B, T, H) * 2.0 + 1.0, r(B, H, dqk, dv) * 0.1, np.abs(r(B, H, dqk)) * 0.1,
         r(B, H) * 0.1]
    cots = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, T, H * dv), (B, H, dqk, dv), (B, H, dqk), (B, H))]
    monkeypatch.setattr(jmf, "_fused_fwd_impl",
                        functools.partial(jmf._fused_fwd_impl.__wrapped__, interpret=True))
    want = jmf.mlstm_fused(*map(jnp.asarray, d), chunk)
    tr = lambda x, dd: x.reshape(B, T, H, dd).transpose(0, 2, 1, 3)

    def chunkwise(q, k, v, i_raw, f_raw, C0, n0, m0):
        h, C_T, n_T, m_T = j_chunkwise(tr(q, dqk), tr(k, dqk), tr(v, dv),
                                       i_raw.transpose(0, 2, 1), f_raw.transpose(0, 2, 1), C0,
                                       n0, m0, chunk)
        return h.transpose(0, 2, 1, 3).reshape(B, T, H * dv), C_T, n_T, m_T

    _, vjp = jax.vjp(chunkwise, *map(jnp.asarray, d))
    jgrads = vjp(tuple(map(jnp.asarray, cots)))
    xs = [torch.from_numpy(x).requires_grad_() for x in d]
    got = mf.mlstm_fused(*xs, chunk)
    for name, a, b in zip(("h", "C_T", "n_T", "m_T"), got, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=2e-4, atol=2e-5,
                                   err_msg=name)
    torch.autograd.backward(got, [torch.from_numpy(c) for c in cots])
    for name, x, g in zip(NAMES, xs, jgrads):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(g), rtol=5e-3, atol=5e-4,
                                   err_msg=f"d_{name}")


@pytest.mark.parametrize("B,H,T,dqk,dv,chunk", [(1, 2, 600, 8, 8, 512), (1, 1, 40, 512, 1024, 16),
                                                (2, 1, 1100, 512, 16, 512)])
def test_kernel_checks_take_any_chunk_and_width(B, H, T, dqk, dv, chunk):
    """K9's ``_check`` and K10's take chunk 512 and dqk 512; B·H above the
    grids' 65535 still raises, naming the limit."""
    from statecatcher_tpu_torch.ops import mlstm_pallas as mp

    L = min(chunk, max(8, T))
    Tp = -(-T // L) * L
    z = lambda *s: torch.zeros(s)
    lane = [z(B, Tp, H * dqk), z(B, Tp, H * dqk), z(B, Tp, H * dv), z(B, H, Tp), z(B, H, Tp),
            z(B, H, dqk, dv), z(B, H, dqk), z(B, H)]
    assert mf._check(*lane, L, T) == (B, Tp, H, dqk, dv, L)
    head = [z(B, H, T, dqk), z(B, H, T, dqk), z(B, H, T, dv), z(B, H, T), z(B, H, T),
            z(B, H, dqk, dv), z(B, H, dqk), z(B, H)]
    assert mp._check(*head, chunk) == (B, H, T, dqk, dv)
    n = mf.MAX_GRID_YZ + 1
    with pytest.raises(ValueError, match="65535 heads"):
        mf._check(z(n, 8, 1), z(n, 8, 1), z(n, 8, 1), z(n, 1, 8), z(n, 1, 8), z(n, 1, 1, 1),
                  z(n, 1, 1), z(n, 1), 8, 8)
    with pytest.raises(ValueError, match="65535 heads"):
        mp._check(z(n, 1, 8, 1), z(n, 1, 8, 1), z(n, 1, 8, 1), z(n, 1, 8), z(n, 1, 8),
                  z(n, 1, 1, 1), z(n, 1, 1), z(n, 1), 8)


@pytest.mark.parametrize("dqk,dv,bwd,most", [(512, 1024, True, 4147), (128, 256, True, 6860),
                                             (64, 64, True, 7782), (512, 1024, False, 19424)])
def test_kernel_checks_name_the_largest_chunk(dqk, dv, bwd, most):
    """A chunk whose blocks would not fit an H100's 227 KB of shared memory
    raises ValueError naming the largest that fits (the launchers' sizes:
    K9b's row kernel at dqk 512 and 128, its dv kernel at dv 64, fwd_out in
    the forward); that chunk passes K9's ``_check`` (K10's for the forward)."""
    from statecatcher_tpu_torch.ops import mlstm_pallas as mp

    assert mf.max_chunk(dqk, dv, bwd) == most
    z = lambda *s: torch.zeros(s)
    carry = [z(1, 1, dqk, dv), z(1, 1, dqk), z(1, 1)]
    for L in (most, most + 1):
        if bwd:
            call = lambda: mf._check(z(1, L, dqk), z(1, L, dqk), z(1, L, dv), z(1, 1, L),
                                     z(1, 1, L), *carry, L, L, bwd=True)
        else:
            call = lambda: mp._check(z(1, 1, 8, dqk), z(1, 1, 8, dqk), z(1, 1, 8, dv), z(1, 1, 8),
                                     z(1, 1, 8), *carry, L)
        if L == most:
            call()
        else:
            with pytest.raises(ValueError, match=f"at most {most} rows.*227 KB"):
                call()
