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

Two routes on the card, chosen from the shape alone before launch by
``wavefront_route``, which the wrappers pass to the kernels (a failed launch
raises; neither route stands in for the other):

  wavefront  U+1 ≤ 1024 and T·(U+1) < 2³¹: the anti-diagonal wavefront of
             ``ops/csrc/rnnt_wavefront.cuh`` with no band, a block of two
             warps a row (a producer warp builds each diagonal's cell records
             from a ring of frame rows, a consumer warp walks the chain, one
             shuffle and one logaddexp a diagonal): T + U diagonals a row;
  scan       U+1 up to 4096 otherwise: a block a row, a frame a step, each
             frame's u-chain a log-step scan across the block's warps.

Bounds on the card (bytes; see the source): each kernel reads blank and
emit and writes one (B, T, U+1) f32 array, 30 MB at B=32, T=1598, U=48;
the chain of dependent cells sets the time.

``rnnt_alpha_ref`` and ``rnnt_beta_ref`` are the plain versions, each in the
operations and order of the card's route for the shape (``order`` picks
one): on the wavefront's shapes a loop over the anti-diagonals d = t + u,
each diagonal one vector of torch operations, so that on the card the
kernels give the plain versions' bits on every live value (dead values, ≤
−1e29, may differ); on the scan's, the frame loop with each chain solved by
a log-step scan (``chain_scan``), as the TPU kernel and the scan kernel do.
In float32 at T = 1598 the two orders round α and β apart, and the
occupancies, which divide by the forward's single Z, turn that into
gradients a few percent apart; ``chip_smoke.py`` phase 9 measures the
training gradient of each order against the plain path in float64.  Each
wrapper runs its plain version only for tensors on the CPU; on the card it
launches or raises.
"""

from __future__ import annotations

import torch

NEG = -1e30
_MAX_STATES = 4 * 1024          # the scan route: 4 columns a thread, 1024 threads (rnnt_lattice.cu)
_MAX_WAVEFRONT = 1024           # the wavefront's widest row (rnnt_wavefront.cuh kMaxWp)
_RENORM = 8                     # diagonals between the walk's shifts (rnnt_wavefront.cuh kRenorm)
_SHIFT_FROM = 512               # the largest live message must be below −this (kShiftFrom)


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


def _skew(x: torch.Tensor, n_diag: int) -> torch.Tensor:
    """(B, T, W) → (B, n_diag, W) with row d holding diagonal d = t + u
    (entry u is x[:, d − u, u]), −1e30 where d − u is outside [0, T)."""
    T, W = x.shape[1], x.shape[2]
    t = torch.arange(n_diag, device=x.device)[:, None] - torch.arange(W, device=x.device)
    idx = t.clamp(0, T - 1)[None].expand(x.shape[0], n_diag, W)
    return torch.where((t >= 0) & (t < T), torch.gather(x, 1, idx), NEG)


def _unskew(diags: torch.Tensor, T: int) -> torch.Tensor:
    """(B, n_diag, W) diagonals → (B, T, W): entry (t, u) from row t + u."""
    W = diags.shape[2]
    idx = torch.arange(T, device=diags.device)[:, None] + torch.arange(W, device=diags.device)
    return torch.gather(diags, 1, idx[None].expand(diags.shape[0], T, W))


def _diagonal_walk(blank_lp, emit_lp, t_lens, u_lens, rev: bool):
    """α (``rev`` False) or β by anti-diagonals, in the wavefront kernels'
    operations and order (``ops/csrc/rnnt_wavefront.cuh``), so that on the
    card the kernels give these values' bits (torch.logaddexp's
    expf/log1pf):
      α(t,u) = logaddexp(up, right), up = α(t−1,u) + blank(t−1,u) (0 at the
        start cell), right = α(t,u−1) + emit(t,u−1);
      β(t,u) = logaddexp(blank(t,u) + up, emit(t,u) + right), up = β(t+1,u)
        (the virtual base at t = t_last), right = β(t,u+1);
    an edge from outside the lattice −1e30.  Rows past t_last repeat α's
    last row or hold β's base; t_len ≤ 0 runs no frame.

    The walk keeps each row's values less a shift S: before every 8th
    diagonal of the row's walk (α's from d = 0, β's from d = t_last + U)
    whose largest live message is below −512, the messages drop by δ =
    its floor and S grows by δ; each value is stored as x + S.  S is a
    whole number, exact in f32, so the chain adds its log-probs to values
    under ~600 rather than to α and β of ~10⁴ (at T = 1598), whose f32
    spacing (~1e-3) rounds every step: unshifted, a row's occupancies
    summed 3–4 % off float64's there, shifted ~1e-4; a stored value rounds
    once.  Lattices whose values stay above −512 are never shifted.  β's
    base enters while S = 0 (no live value comes before it)."""
    bl, em, cdt = _prep(blank_lp, emit_lp)
    B, T, U1 = bl.shape
    dev = bl.device
    n_diag = T + U1 - 1
    last = torch.clamp(t_lens.to(dev).to(torch.int64), max=T)[:, None] - 1   # (B, 1)
    lane = torch.arange(U1, device=dev)
    neg = torch.full((B, 1), NEG, dtype=cdt, device=dev)
    em = torch.cat([em, neg[:, None].expand(B, T, 1)], dim=2)   # column U has no emit
    # one (B, U+1) view per diagonal: their backward forms each full-size
    # gradient once, not once per diagonal
    bsk, esk = _skew(bl, n_diag).unbind(1), _skew(em, n_diag).unbind(1)
    if rev:
        base = torch.where(lane == u_lens.to(dev)[:, None], 0.0, NEG).to(cdt)
    diags = [None] * n_diag
    up_msg = right_msg = torch.full((B, U1), NEG, dtype=cdt, device=dev)
    shift = torch.zeros((B, 1), dtype=cdt, device=dev)
    for d in (range(n_diag - 1, -1, -1) if rev else range(n_diag)):
        step = last + (U1 - 1) - d if rev else torch.full_like(last, d)   # of the row's walk
        due = (step > 0) & (step % _RENORM == 0)
        if bool(due.any()):
            top = (up_msg if rev else torch.maximum(up_msg, right_msg)).amax(1, keepdim=True)
            delta = torch.where(due & (top > -1e29) & (top < -_SHIFT_FROM), torch.floor(top),
                                0.0).detach()
            up_msg, right_msg, shift = up_msg - delta, right_msg - delta, shift + delta
        t = d - lane
        live = (t >= 0) & (t <= last)
        if rev:
            up = torch.where(t == last, base, up_msg)
            right = torch.cat([up_msg[:, 1:], neg], dim=1)
            x = torch.logaddexp(bsk[d] + up, esk[d] + right)
        else:
            up = torch.where((t == 0) & (lane == 0), 0.0, up_msg)
            right = torch.cat([neg, right_msg[:, :-1]], dim=1)
            x = torch.logaddexp(up, right)
        x = torch.where(live, x, NEG)
        diags[d] = x + shift
        if rev:
            up_msg = x
        else:
            up_msg, right_msg = x + bsk[d], x + esk[d]
    out = _unskew(torch.stack(diags, dim=1), T)
    rows = torch.arange(T, device=dev)[None, :, None]
    if rev:
        return torch.where(rows > last[:, :, None], base[:, None, :], out)
    start = torch.where(lane == 0, 0.0, NEG).to(cdt)
    tail = torch.gather(out, 1, last.clamp(min=0)[:, :, None].expand(B, 1, U1))
    out = torch.where(rows > last[:, :, None], tail, out)
    return torch.where(last[:, :, None] < 0, start, out)


def _scan_alpha(bl, em, t_lens):
    """α by frames, each frame's chain solved by ``chain_scan`` (the scan
    route's order)."""
    B, T, U1 = bl.shape
    dev = bl.device
    first = torch.full((B, 1), NEG, dtype=bl.dtype, device=dev)
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


def _scan_beta(bl, em, t_lens, u_lens):
    """β by frames, walking down, each chain by ``chain_scan``."""
    B, T, U1 = bl.shape
    dev = bl.device
    lane = torch.arange(U1, device=dev)[None, :]
    carry = torch.where(lane == u_lens.to(dev)[:, None], 0.0, NEG).to(bl.dtype)
    last = torch.full((B, 1), NEG, dtype=bl.dtype, device=dev)
    live = t_lens.to(dev)[:, None]
    out = torch.empty((B, T, U1), dtype=bl.dtype, device=dev)
    for t in range(T - 1, -1, -1):
        x = chain_scan(torch.cat([em[:, t], last], dim=1), bl[:, t] + carry, reverse=True)
        carry = torch.where(t < live, x, carry)
        out[:, t] = carry
    return out


def wavefront_route(T: int, U1: int) -> bool:
    """Whether K7 takes the wavefront (else the scan): U+1 ≤ 1024 and
    T·(U+1) < 2³¹.  The one choice of route: the wrappers pass it to the
    kernels, and the plain versions take its order."""
    return U1 <= _MAX_WAVEFRONT and T * U1 < 2**31


def _diagonal_order(order: str | None, shape) -> bool:
    if order is None:
        return wavefront_route(shape[1], shape[2])
    if order not in ("diagonals", "frames"):
        raise ValueError(f"order must be 'diagonals', 'frames' or None, got {order!r}")
    return order == "diagonals"


# --------------------------------------------------------------------------- #
# Plain versions
# --------------------------------------------------------------------------- #
def rnnt_alpha_ref(blank_lp: torch.Tensor, emit_lp: torch.Tensor, t_lens: torch.Tensor,
                   order: str | None = None) -> torch.Tensor:
    """Plain K7a: every α (B, T, U+1) in f32 (f64 for f64 inputs), by
    ``order``: "diagonals" as the wavefront walks them, "frames" of
    log-step scans as the scan kernel (and the TPU kernel), None the card's
    route's for the shape.  The start state is (0, −1e30, …); rows t ≥
    t_len repeat the last row.  Differentiable: the transducer loss of
    ``ops/rnnt.py`` runs through it."""
    if _diagonal_order(order, blank_lp.shape):
        return _diagonal_walk(blank_lp, emit_lp, t_lens, None, rev=False)
    bl, em, _ = _prep(blank_lp, emit_lp)
    return _scan_alpha(bl, em, t_lens)


def rnnt_beta_ref(blank_lp: torch.Tensor, emit_lp: torch.Tensor, t_lens: torch.Tensor,
                  u_lens: torch.Tensor, order: str | None = None) -> torch.Tensor:
    """Plain K7b: every β (B, T, U+1) in f32 (f64 for f64 inputs), in
    ``order`` as ``rnnt_alpha_ref``'s, from the virtual base (0 at u =
    u_len, −1e30 elsewhere), which rows t ≥ t_len keep."""
    if _diagonal_order(order, blank_lp.shape):
        return _diagonal_walk(blank_lp, emit_lp, t_lens, u_lens, rev=True)
    bl, em, _ = _prep(blank_lp, emit_lp)
    return _scan_beta(bl, em, t_lens, u_lens)


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
                 out.data_ptr(), B, T, U1, int(wavefront_route(T, U1)),
                 torch.cuda.current_stream(dev).cuda_stream)
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
