"""The banded transducer loss of the PyTorch port (``ops/rnnt_band.py``: the
plain versions of K8a/K8b and of the banded lattice) against the JAX
package's ``ops/rnnt_band.py``, whose Pallas kernels run in interpret mode
on the CPU as tests/test_rnnt_band.py runs them:

- ``band_offsets``: the same integers for ragged lengths, a degenerate row
  and t_len = 0 included;
- the banded tables (``joint_blank_emit_banded``) in float32 and bfloat16;
- the loss and its gradients for enc, pred, kernel and bias at a band that
  really prunes (band 4, time block 8, U 24), with a row_valid=False row:
  loss to rtol 1e-5, gradients to rtol 2e-4 plus 2e-5 (the JAX tests'
  tolerances);
- a full-width band equals the port's exact loss (values and gradients);
- a degenerate row (its band never holds its corner) is left out of the
  mean, with zero, finite gradients;
- the occupancy backward of the banded lattice equals autograd through its
  plain forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import statecatcher_tpu.ops.rnnt_band as jrb
from statecatcher_tpu_torch.ops import rnnt_band as rb
from statecatcher_tpu_torch.ops.rnnt_joint import rnnt_loss_pallas
from test_torch_cuda import single_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_torch_thread")


@pytest.fixture(autouse=True)
def _interpret():
    jrb._INTERPRET[0] = True
    yield
    jrb._INTERPRET[0] = False


def _problem(seed, B=3, T=40, U=24, J=8, V=20):
    rng = np.random.default_rng(seed)
    enc = (rng.standard_normal((B, T, J)) * 0.4).astype(np.float32)
    pred = (rng.standard_normal((B, U + 1, J)) * 0.4).astype(np.float32)
    k = (rng.standard_normal((J, V)) * 0.3).astype(np.float32)
    b = (rng.standard_normal(V) * 0.1).astype(np.float32)
    labels = rng.integers(1, V, (B, U)).astype(np.int32)
    return enc, pred, k, b, labels


@pytest.mark.parametrize("Tb,Wp,Tp,U1p", [(8, 24, 104, 72), (8, 48, 1600, 136), (16, 32, 96, 40)])
def test_band_offsets_match_jax(Tb, Wp, Tp, U1p):
    rng = np.random.default_rng(Tp + Wp)
    B = 9
    t_lens = rng.integers(1, Tp + 1, B).astype(np.int32)
    u_lens = rng.integers(0, U1p, B).astype(np.int32)
    t_lens[:3] = [Tp, 0, 3]                                  # full, empty, inside block 0
    u_lens[:3] = [U1p - 1, 0, U1p - 1]                       # row 2: degenerate
    want = np.asarray(jrb.band_offsets(jnp.asarray(t_lens), jnp.asarray(u_lens), Tp, U1p, Wp, Tb))
    got = rb.band_offsets(torch.from_numpy(t_lens), torch.from_numpy(u_lens), Tp, U1p, Wp, Tb)
    assert got.dtype == torch.int32 and got.shape == (B, Tp // Tb)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_banded_tables_match_jax(dtype):
    """The forward tables; in bfloat16 both round the joint, the kernel and
    the bias for the logits and keep the emit column in float32."""
    enc, pred, k, b, labels = _problem(3)
    t_lens = np.array([40, 35, 31], np.int32)
    u_lens = np.array([24, 21, 12], np.int32)
    band, Tb = 4, 8
    Wp = rb.band_width(band, 25, Tb)
    o = np.array(jrb.band_offsets(jnp.asarray(t_lens), jnp.asarray(u_lens), 40, 32, Wp, Tb))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jb_, je_ = jrb.joint_blank_emit_banded(jnp.asarray(enc, jdt), jnp.asarray(pred, jdt),
                                           jnp.asarray(k), jnp.asarray(b), jnp.asarray(labels),
                                           jnp.asarray(o), Wp, blank_id=0, time_block=Tb)
    tdt = getattr(torch, dtype)
    got = rb.joint_blank_emit_banded(torch.from_numpy(enc).to(tdt), torch.from_numpy(pred).to(tdt),
                                     torch.from_numpy(k), torch.from_numpy(b),
                                     torch.from_numpy(labels), torch.from_numpy(o), Wp,
                                     blank_id=0, time_block=Tb)
    for name, g, w in zip(("blank", "emit"), got, (jb_, je_)):
        assert g.dtype == torch.float32 and g.shape == (3, 40, Wp)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5, err_msg=name)


def test_loss_and_grads_match_jax_at_a_pruning_band():
    enc, pred, k, b, labels = _problem(5)
    t_lens = np.array([40, 35, 31], np.int32)
    u_lens = np.array([24, 21, 12], np.int32)
    row_valid = np.array([True, True, False])

    def f(*xs):
        return jrb.rnnt_loss_banded(*xs, jnp.asarray(labels), jnp.asarray(t_lens),
                                    jnp.asarray(u_lens), blank_id=0,
                                    row_valid=jnp.asarray(row_valid), band=4, time_block=8)

    jl, jg = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2, 3)))(
        *map(jnp.asarray, (enc, pred, k, b)))
    xs = [torch.from_numpy(x).requires_grad_() for x in (enc, pred, k, b)]
    loss, per = rb.rnnt_loss_banded(*xs, *map(torch.from_numpy, (labels, t_lens, u_lens)),
                                    blank_id=0, row_valid=torch.from_numpy(row_valid), band=4,
                                    time_block=8, return_per=True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    for name, x, g in zip(("enc", "pred", "kernel", "bias"), xs, jg):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(g), rtol=2e-4, atol=2e-5,
                                   err_msg=name)
    assert not xs[0].grad[2].any()                               # the invalid row
    # the band prunes: the loss is above the exact one (fewer paths summed)
    exact = rnnt_loss_pallas(*(x.detach() for x in xs),
                             *map(torch.from_numpy, (labels, t_lens, u_lens)),
                             row_valid=torch.from_numpy(row_valid))
    assert loss.item() > exact.item() + 1e-6


def test_full_band_equals_the_exact_loss():
    """In float64, where neither loss's occupancies drift: to 1e-10."""
    enc, pred, k, b, labels = _problem(7, T=24, U=10)
    t_lens = torch.tensor([24, 19, 15], dtype=torch.int32)
    u_lens = torch.tensor([10, 7, 0], dtype=torch.int32)
    outs = []
    for fn in (lambda *a: rb.rnnt_loss_banded(*a, band=11), rnnt_loss_pallas):
        xs = [torch.from_numpy(x).double().requires_grad_() for x in (enc, pred, k, b)]
        loss = fn(*xs, torch.from_numpy(labels), t_lens, u_lens)
        loss.backward()
        outs.append((loss.item(), [x.grad.numpy() for x in xs]))
    np.testing.assert_allclose(outs[0][0], outs[1][0], rtol=1e-12)
    for name, g, w in zip(("enc", "pred", "kernel", "bias"), outs[0][1], outs[1][1]):
        np.testing.assert_allclose(g, w, rtol=1e-10, atol=1e-12, err_msg=name)


def test_degenerate_row_is_masked_out_of_the_mean():
    """Row 2 ends inside the first time block with u_len = U ≥ Wp: the path
    start pins its band at 0 and the corner is never covered."""
    enc, pred, k, b, labels = _problem(9, T=24, U=24)
    t_lens = torch.tensor([24, 20, 6], dtype=torch.int32)
    u_lens = torch.tensor([10, 8, 24], dtype=torch.int32)
    xs = [torch.from_numpy(x).requires_grad_() for x in (enc, pred, k, b)]
    loss, per = rb.rnnt_loss_banded(*xs, torch.from_numpy(labels), t_lens, u_lens, band=4,
                                    return_per=True)
    loss.backward()
    clean = rb.rnnt_loss_banded(*(torch.from_numpy(x[:2]) for x in (enc, pred)),
                                torch.from_numpy(k), torch.from_numpy(b),
                                torch.from_numpy(labels[:2]), t_lens[:2], u_lens[:2], band=4)
    np.testing.assert_allclose(loss.item(), clean.item(), rtol=1e-5)
    assert per[2].item() == 0.0 and np.isfinite(loss.item())
    assert all(torch.isfinite(x.grad).all() for x in xs)
    assert not xs[0].grad[2].any() and not xs[1].grad[2].any()


def test_lattice_occupancies_equal_autograd_of_the_plain_forward():
    """The β kernel's plain version and the occupancy step give the gradient
    that autograd takes through the plain α recursion (float64)."""
    rng = np.random.default_rng(11)
    B, Tp, Wp, Tb = 3, 32, 16, 8
    blank = torch.from_numpy(rng.standard_normal((B, Tp, Wp)) - 1.5).requires_grad_()
    emit = torch.from_numpy(rng.standard_normal((B, Tp, Wp)) - 1.5).requires_grad_()
    o = torch.tensor([[0, 8, 8, 16], [0, 0, 8, 8], [0, 0, 0, 0]], dtype=torch.int32)
    t_lens = torch.tensor([32, 21, 5], dtype=torch.int32)
    u_lens = torch.tensor([20, 9, 3], dtype=torch.int32)
    alpha = rb.rnnt_band_alpha_ref(blank, emit, o, t_lens, Tb)
    want = rb.band_nll_from_alpha(alpha, blank, o, t_lens, u_lens, Tb)
    w = torch.tensor([1.0, 0.5, 2.0], dtype=torch.float64)
    wb, we = torch.autograd.grad((want * w).sum(), (blank, emit))
    got = rb.rnnt_nll_banded(blank, emit, o, t_lens, u_lens, Tb)
    gb, ge = torch.autograd.grad((got * w).sum(), (blank, emit))
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=1e-12)
    np.testing.assert_allclose(gb.numpy(), wb.numpy(), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(ge.numpy(), we.numpy(), rtol=1e-9, atol=1e-12)
