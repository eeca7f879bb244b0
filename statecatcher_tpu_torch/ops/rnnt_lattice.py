"""RNN-T lattice α/β with an occupancy backward: K7a (α) and K7b (β).

Replaces the TPU kernels of ``statecatcher_tpu/ops/rnnt_dp_pallas.py``:
``_alpha_kernel`` (:69, launched by ``_alpha_all``, :143) and ``_beta_kernel``
(:93, launched by ``_beta_all``, :182), with the kernels of
``ops/csrc/rnnt_lattice.cu``.  ``rnnt_nll_dp_pallas`` is the same function as
the JAX package's (a ``custom_vjp`` there, a ``torch.autograd.Function``
here):

  forward   (blank (B, T, U+1), emit (B, T, U)) → α (K7a), every row, f32 →
            NLL = −(α(t_len−1, u_len) + blank(t_len−1, u_len))
  backward  β (K7b) → the edge occupancies
              ∂nll/∂blank(t,u) = −exp(α(t,u) + blank(t,u) + β(t+1,u) − log Z)
              ∂nll/∂emit(t,u)  = −exp(α(t,u) + emit(t,u) + β(t,u+1) − log Z)
            with the exponent clipped to ±80 and zero for t ≥ t_len, times
            the NLL's cotangent

The occupancy step is plain PyTorch, as it was XLA outside the Pallas
kernels.  Per frame both lattices solve the first-order chain
``x_u = logaddexp(base_u, x_{u∓1} + a_u)``: α with base_u = α(t−1,u) +
blank(t−1,u) and a_u = emit(t,u−1), β (walking u and t downwards) with
base_u = blank(t,u) + β(t+1,u) and a_u = emit(t,u).  Rows t ≥ t_len keep α
frozen at its last row and β at its virtual base (0 at u = u_len, −1e30
elsewhere).

Bounds on the card (bytes; see the source): each kernel reads blank and
emit and writes one (B, T, U+1) f32 array, 30 MB at B=32, T=1598, U=48;
the chain of T dependent frames sets the time.

``rnnt_alpha_ref`` and ``rnnt_beta_ref`` are the plain versions: the frame
loop with each chain solved by a log-step (Hillis-Steele) scan over u in the
(logaddexp, +) semiring, as the TPU kernel does.  Each wrapper runs its plain
version only for tensors on the CPU; on the card it launches or raises.
"""

from __future__ import annotations

import torch

NEG = -1e30
_MAX_STATES = 4 * 1024          # 4 lattice columns per thread, 1024 threads (rnnt_lattice.cu)


def chain_scan(a: torch.Tensor, base: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Solve x_u = logaddexp(base_u, x_{u−1} + a_u) (``reverse``: x_{u+1})
    along the last axis by a log-step scan; a at the first element (the last
    when reversed) has no predecessor and is ignored.  Affine maps
    s ↦ logaddexp(b, s + a) compose as (a₁, b₁) then (a₂, b₂) →
    (a₁ + a₂, logaddexp(b₁ + a₂, b₂))."""
    if reverse:
        return chain_scan(a.flip(-1), base.flip(-1)).flip(-1)
    n = a.shape[-1]
    A, Bv = a, base
    k = 1
    while k < n:
        a_sh = torch.cat([torch.zeros_like(A[..., :k]), A[..., :-k]], dim=-1)
        b_sh = torch.cat([torch.full_like(Bv[..., :k], NEG), Bv[..., :-k]], dim=-1)
        Bv = torch.logaddexp(b_sh + A, Bv)
        A = a_sh + A
        k *= 2
    return Bv


def _prep(blank_lp, emit_lp):
    cdt = torch.promote_types(blank_lp.dtype, torch.float32)
    return blank_lp.to(cdt), emit_lp.to(cdt), cdt


# --------------------------------------------------------------------------- #
# Plain versions
# --------------------------------------------------------------------------- #
def rnnt_alpha_ref(blank_lp: torch.Tensor, emit_lp: torch.Tensor,
                   t_lens: torch.Tensor) -> torch.Tensor:
    """Plain K7a: every α (B, T, U+1) in f32 (f64 for f64 inputs).  The
    start state is (0, −1e30, …); rows t ≥ t_len repeat the last row.
    Differentiable: the transducer loss of ``ops/rnnt.py`` runs through it."""
    bl, em, cdt = _prep(blank_lp, emit_lp)
    B, T, U1 = bl.shape
    dev = bl.device
    first = torch.full((B, 1), NEG, dtype=cdt, device=dev)
    carry = torch.cat([torch.zeros_like(first), first.expand(B, U1 - 1)], dim=1)
    live = t_lens.to(dev)[:, None]
    # one (B, ·) view per frame, rows gathered by one stack: their backward
    # forms each full-size gradient once, not once per frame
    blank_t, emit_t = bl.unbind(1), em.unbind(1)
    rows = []
    for t in range(T):
        base = carry + blank_t[t - 1] if t > 0 else carry
        x = chain_scan(torch.cat([first, emit_t[t]], dim=1), base)
        carry = torch.where(t < live, x, carry)
        rows.append(carry)
    return torch.stack(rows, dim=1)


def rnnt_beta_ref(blank_lp: torch.Tensor, emit_lp: torch.Tensor, t_lens: torch.Tensor,
                  u_lens: torch.Tensor) -> torch.Tensor:
    """Plain K7b: every β (B, T, U+1) in f32 (f64 for f64 inputs), walking
    time backwards from the virtual base (0 at u = u_len, −1e30 elsewhere),
    which rows t ≥ t_len keep."""
    bl, em, cdt = _prep(blank_lp, emit_lp)
    B, T, U1 = bl.shape
    dev = bl.device
    lane = torch.arange(U1, device=dev)[None, :]
    carry = torch.where(lane == u_lens.to(dev)[:, None], 0.0, NEG).to(cdt)
    last = torch.full((B, 1), NEG, dtype=cdt, device=dev)
    live = t_lens.to(dev)[:, None]
    out = torch.empty((B, T, U1), dtype=cdt, device=dev)
    for t in range(T - 1, -1, -1):
        x = chain_scan(torch.cat([em[:, t], last], dim=1), bl[:, t] + carry, reverse=True)
        carry = torch.where(t < live, x, carry)
        out[:, t] = carry
    return out


# --------------------------------------------------------------------------- #
# Kernel wrappers
# --------------------------------------------------------------------------- #
def _check(blank_lp, emit_lp, lens):
    if blank_lp.dtype != torch.float32 or emit_lp.dtype != torch.float32:
        raise TypeError(f"blank and emit must be float32, got {blank_lp.dtype}, {emit_lp.dtype}")
    if blank_lp.ndim != 3:
        raise ValueError(f"blank must be (B, T, U+1), got {tuple(blank_lp.shape)}")
    B, T, U1 = blank_lp.shape
    if min(B, T, U1) == 0 or U1 > _MAX_STATES:
        raise ValueError(f"unsupported lattice shape {tuple(blank_lp.shape)} "
                         f"(at most {_MAX_STATES} label positions)")
    if emit_lp.shape != (B, T, U1 - 1):
        raise ValueError(f"emit {tuple(emit_lp.shape)} does not fit blank {tuple(blank_lp.shape)}")
    for name, t in (("emit", emit_lp), *lens):
        if t.device != blank_lp.device:
            raise ValueError(f"{name} is on {t.device}, blank on {blank_lp.device}")
        if name != "emit" and t.shape != (B,):
            raise ValueError(f"{name} must be ({B},), got {tuple(t.shape)}")
    if not (blank_lp.is_contiguous() and emit_lp.is_contiguous()):
        raise ValueError("blank and emit must be contiguous")
    return B, T, U1


def _launch(fn_name, blank_lp, emit_lp, lens):
    B, T, U1 = _check(blank_lp, emit_lp, lens)
    dev = blank_lp.device
    lens32 = [t.to(torch.int32).contiguous() for _, t in lens]

    from statecatcher_tpu_torch.ops._kernels import library

    fn = getattr(library("rnnt_lattice"), fn_name)
    out = torch.empty((B, T, U1), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = fn(blank_lp.data_ptr(), emit_lp.data_ptr(), *(t.data_ptr() for t in lens32),
                 out.data_ptr(), B, T, U1, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: cudaError {err}")
    return out


def rnnt_alpha(blank_lp: torch.Tensor, emit_lp: torch.Tensor,
               t_lens: torch.Tensor) -> torch.Tensor:
    """K7a: blank (B, T, U+1), emit (B, T, U) f32, t_lens (B,) → α (B, T, U+1).

    On CUDA tensors this launches ``rnnt_alpha`` and counts it in
    ``rnnt_alpha.launches``; on CPU tensors it runs the plain version."""
    if not blank_lp.is_cuda:
        return rnnt_alpha_ref(blank_lp, emit_lp, t_lens)
    out = _launch("rnnt_alpha", blank_lp, emit_lp, [("t_lens", t_lens)])
    rnnt_alpha.launches += 1
    return out


rnnt_alpha.launches = 0


def rnnt_beta(blank_lp: torch.Tensor, emit_lp: torch.Tensor, t_lens: torch.Tensor,
              u_lens: torch.Tensor) -> torch.Tensor:
    """K7b: blank, emit, t_lens, u_lens → β (B, T, U+1).

    On CUDA tensors this launches ``rnnt_beta`` and counts it in
    ``rnnt_beta.launches``; on CPU tensors it runs the plain version."""
    if not blank_lp.is_cuda:
        return rnnt_beta_ref(blank_lp, emit_lp, t_lens, u_lens)
    out = _launch("rnnt_beta", blank_lp, emit_lp, [("t_lens", t_lens), ("u_lens", u_lens)])
    rnnt_beta.launches += 1
    return out


rnnt_beta.launches = 0


# --------------------------------------------------------------------------- #
# The NLL with its occupancy backward
# --------------------------------------------------------------------------- #
def nll_from_alpha(alpha: torch.Tensor, blank_lp: torch.Tensor, t_lens: torch.Tensor,
                   u_lens: torch.Tensor) -> torch.Tensor:
    """(B,) NLL −(α + blank) at (t_len − 1, u_len), t clamped at 0."""
    B = alpha.shape[0]
    rows = torch.arange(B, device=alpha.device)
    t_idx = torch.clamp(t_lens.to(torch.int64) - 1, min=0)
    ul = u_lens.to(torch.int64)
    return -(alpha[rows, t_idx, ul] + blank_lp[rows, t_idx, ul])


def occupancy_grads(blank_lp, emit_lp, t_lens, u_lens, alpha, beta, nll, g):
    """(∂/∂blank, ∂/∂emit) of Σ g·nll from α, β (``_nll_bwd`` of the JAX
    package: exponents clipped to ±80, frames t ≥ t_len zero)."""
    B, T, U1 = blank_lp.shape
    dev, cdt = alpha.device, alpha.dtype
    lane = torch.arange(U1, device=dev)[None, :]
    base = torch.where(lane == u_lens.to(dev)[:, None], 0.0, NEG).to(cdt)
    beta_next = torch.cat([beta[:, 1:], base[:, None]], dim=1)
    log_z = -nll[:, None, None]
    active = torch.arange(T, device=dev)[None, :, None] < t_lens.to(dev)[:, None, None]
    zero = torch.zeros((), dtype=cdt, device=dev)
    occ_blank = torch.exp(torch.clamp(alpha + blank_lp + beta_next - log_z, -80.0, 80.0))
    occ_emit = torch.exp(torch.clamp(alpha[:, :, :-1] + emit_lp + beta[:, :, 1:] - log_z,
                                     -80.0, 80.0))
    gs = -g.to(cdt)[:, None, None]
    return (torch.where(active, occ_blank, zero) * gs, torch.where(active, occ_emit, zero) * gs)


class _RNNTLattice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, blank_lp, emit_lp, t_lens, u_lens):
        bl, em = blank_lp.contiguous(), emit_lp.contiguous()
        alpha = rnnt_alpha(bl, em, t_lens)
        nll = nll_from_alpha(alpha, bl.to(alpha.dtype), t_lens, u_lens)
        ctx.save_for_backward(bl, em, t_lens, u_lens, alpha, nll)
        return nll

    @staticmethod
    def backward(ctx, g):
        bl, em, t_lens, u_lens, alpha, nll = ctx.saved_tensors
        beta = rnnt_beta(bl, em, t_lens, u_lens)
        g_blank, g_emit = occupancy_grads(bl.to(alpha.dtype), em.to(alpha.dtype), t_lens, u_lens,
                                          alpha, beta, nll, g)
        return g_blank.to(bl.dtype), g_emit.to(em.dtype), None, None


def rnnt_nll_dp_pallas(blank_lp: torch.Tensor, emit_lp: torch.Tensor, t_lens: torch.Tensor,
                       u_lens: torch.Tensor) -> torch.Tensor:
    """Per-example transducer NLL (B,) from (blank (B, T, U+1), emit
    (B, T, U)) log-prob lattices, through K7a forward and K7b backward (their
    plain versions on the CPU)."""
    return _RNNTLattice.apply(blank_lp, emit_lp, t_lens, u_lens)
