"""CTC α/β lattice with a custom backward: K3 (α) and K4 (β).

Replaces the TPU kernels of ``statecatcher_tpu/ops/ctc_pallas.py``:
``_alpha_kernel`` (:58, launched by ``_alpha_all``, :179) and ``_beta_kernel``
(:92, launched by ``_beta_all``, :218), with the kernels of
``ops/csrc/ctc_lattice.cu``.  ``ctc_nll_pallas`` is the same function as the
JAX package's (a ``custom_vjp`` there, a ``torch.autograd.Function`` here):

  forward   log-probs (B, T, V) → emit (B, T, S = 2U+1) f32 by a gather of
            each extended label → α (K3) → NLL from the two terminal states
  backward  β (K4) → occupancy γ = exp(clip(α + β − emit − log Z, ±80)),
            zero for t ≥ in_len → ∂NLL/∂logp(t, v) = −Σ_{s: label s = v} γ
            (a scatter-add over V), times the NLL's cotangent

The γ step and the projection are plain PyTorch, as they were XLA outside
the Pallas kernels.  Everything is float32, as in the JAX package.

Bounds on the card (bytes; see the source): each kernel reads emit and
writes one (B, T, S) f32 array, 105 MB at B=32, T=1598, U=128, 0.031 ms;
the chain of T dependent steps sets the time.

``ctc_alpha_ref`` and ``ctc_beta_ref`` are the plain versions: the two
recursions over all T, vectorised over (B, S).  Each wrapper runs its plain
version only for tensors on the CPU; on the card it launches or raises.
"""

from __future__ import annotations

import torch

NEG = -1e30
_MAX_STATES = 4 * 1024          # 4 states per thread, 1024 threads (ctc_lattice.cu)


def expand_labels(labels: torch.Tensor, blank_id: int) -> torch.Tensor:
    """(B, U) labels → (B, 2U+1) blank-interleaved CTC path labels."""
    B, U = labels.shape
    ext = torch.full((B, 2 * U + 1), blank_id, dtype=labels.dtype, device=labels.device)
    ext[:, 1::2] = labels
    return ext


def skip_allowed(ext: torch.Tensor, blank_id: int) -> torch.Tensor:
    """(B, S) bool: the s−2 → s transition is allowed (non-blank, and a
    different label from two states back)."""
    prev2 = torch.cat([torch.full_like(ext[:, :2], -1), ext[:, :-2]], dim=1)
    return (ext != blank_id) & (ext != prev2)


def emit_log_probs(log_probs: torch.Tensor, ext: torch.Tensor) -> torch.Tensor:
    """Emission lookup (B, T, V) × (B, S) labels → (B, T, S), an exact gather
    (the JAX package's one-hot matmul at HIGHEST precision); its backward is
    a scatter-add over V."""
    B, T, _ = log_probs.shape
    idx = ext.to(torch.int64)[:, None, :].expand(B, T, ext.shape[1])
    return torch.gather(log_probs, 2, idx)


def _lse3(a, b, c):
    """``_logaddexp3`` of the JAX kernel, with its −1e30 floor."""
    m = torch.maximum(torch.maximum(a, b), c)
    ms = torch.clamp(m, min=NEG)
    out = ms + torch.log(torch.exp(a - ms) + torch.exp(b - ms) + torch.exp(c - ms))
    return torch.where(m <= NEG / 2, torch.full_like(out, NEG), out)


# --------------------------------------------------------------------------- #
# Plain versions
# --------------------------------------------------------------------------- #
def ctc_alpha_ref(emit: torch.Tensor, allow_skip: torch.Tensor,
                  in_lens: torch.Tensor) -> torch.Tensor:
    """Plain K3: all α (B, T, S) in f32 (f64 for f64 emit).  t = 0 reaches
    states ≤ 1; rows are frozen for t ≥ in_len."""
    B, T, S = emit.shape
    cdt = torch.promote_types(emit.dtype, torch.float32)
    e = emit.to(cdt)
    neg = torch.full((B, S), NEG, dtype=cdt, device=emit.device)
    col = neg[:, :1]
    skip = allow_skip.to(torch.bool)
    first = (torch.arange(S, device=emit.device) <= 1)[None, :]
    out = torch.empty((B, T, S), dtype=cdt, device=emit.device)
    a = neg
    for t in range(T):
        if t == 0:
            new = torch.where(first, e[:, 0], neg)
        else:
            a1 = torch.cat([col, a[:, :-1]], dim=1)
            a2 = torch.where(skip, torch.cat([col, col, a[:, :-2]], dim=1)[:, :S], neg)
            new = _lse3(a, a1, a2) + e[:, t]
        a = torch.where((t < in_lens)[:, None], new, a)
        out[:, t] = a
    return out


def ctc_beta_ref(emit: torch.Tensor, allow_skip: torch.Tensor, in_lens: torch.Tensor,
                 label_lens: torch.Tensor) -> torch.Tensor:
    """Plain K4: all β (B, T, S) in f32 (f64 for f64 emit), walking time
    backwards: −1e30 for t ≥ in_len, the terminal states (2L, and 2L−1 when
    L > 0) at t = in_len − 1, the mirrored recursion below."""
    B, T, S = emit.shape
    cdt = torch.promote_types(emit.dtype, torch.float32)
    e = emit.to(cdt)
    neg = torch.full((B, S), NEG, dtype=cdt, device=emit.device)
    col = neg[:, :1]
    skip_into = torch.cat([allow_skip[:, 2:].to(torch.bool),
                           torch.zeros_like(allow_skip[:, :2], dtype=torch.bool)], dim=1)[:, :S]
    s_idx = torch.arange(S, device=emit.device)[None, :]
    ll = label_lens[:, None]
    term = torch.where((s_idx == 2 * ll) | ((s_idx == 2 * ll - 1) & (ll > 0)),
                       torch.zeros_like(neg), neg)
    out = torch.empty((B, T, S), dtype=cdt, device=emit.device)
    bt = neg
    for t in range(T - 1, -1, -1):
        b1 = torch.cat([bt[:, 1:], col], dim=1)
        b2 = torch.where(skip_into, torch.cat([bt[:, 2:], col, col], dim=1)[:, :S], neg)
        new = e[:, t] + _lse3(bt, b1, b2)
        new = torch.where((t == in_lens - 1)[:, None], e[:, t] + term, new)
        bt = torch.where((t >= in_lens)[:, None], neg, new)
        out[:, t] = bt
    return out


# --------------------------------------------------------------------------- #
# Kernel wrappers
# --------------------------------------------------------------------------- #
def _check_lattice_args(emit, allow_skip, lens):
    if emit.dtype != torch.float32:
        raise TypeError(f"emit must be float32, got {emit.dtype}")
    if emit.ndim != 3:
        raise ValueError(f"emit must be (B, T, S), got {tuple(emit.shape)}")
    B, T, S = emit.shape
    if min(B, T, S) == 0 or S > _MAX_STATES:
        raise ValueError(f"unsupported lattice shape {tuple(emit.shape)} "
                         f"(at most {_MAX_STATES} states)")
    if allow_skip.shape != (B, S):
        raise ValueError(f"allow_skip {tuple(allow_skip.shape)} does not fit emit "
                         f"{tuple(emit.shape)}")
    for name, t in (("allow_skip", allow_skip), *lens):
        if t.device != emit.device:
            raise ValueError(f"{name} is on {t.device}, emit on {emit.device}")
        if name != "allow_skip" and t.shape != (B,):
            raise ValueError(f"{name} must be ({B},), got {tuple(t.shape)}")
    if not emit.is_contiguous():
        raise ValueError("emit must be contiguous")
    return B, T, S


def _launch(fn_name, emit, allow_skip, lens):
    B, T, S = _check_lattice_args(emit, allow_skip, lens)
    dev = emit.device
    skip8 = allow_skip.to(torch.uint8).contiguous()
    lens32 = [t.to(torch.int32).contiguous() for _, t in lens]

    from statecatcher_tpu_torch.ops._kernels import library

    fn = getattr(library("ctc_lattice"), fn_name)
    out = torch.empty((B, T, S), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = fn(emit.data_ptr(), skip8.data_ptr(), *(t.data_ptr() for t in lens32),
                 out.data_ptr(), B, T, S, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: cudaError {err}")
    return out


def ctc_alpha(emit: torch.Tensor, allow_skip: torch.Tensor,
              in_lens: torch.Tensor) -> torch.Tensor:
    """K3: emit (B, T, S) f32, allow_skip (B, S), in_lens (B,) → α (B, T, S).

    On CUDA tensors this launches ``ctc_alpha`` and counts it in
    ``ctc_alpha.launches``; on CPU tensors it runs the plain version."""
    if not emit.is_cuda:
        return ctc_alpha_ref(emit, allow_skip, in_lens)
    out = _launch("ctc_alpha", emit, allow_skip, [("in_lens", in_lens)])
    ctc_alpha.launches += 1
    return out


ctc_alpha.launches = 0


def ctc_beta(emit: torch.Tensor, allow_skip: torch.Tensor, in_lens: torch.Tensor,
             label_lens: torch.Tensor) -> torch.Tensor:
    """K4: emit (B, T, S) f32, allow_skip (B, S), in_lens, label_lens (B,) →
    β (B, T, S).

    On CUDA tensors this launches ``ctc_beta`` and counts it in
    ``ctc_beta.launches``; on CPU tensors it runs the plain version."""
    if not emit.is_cuda:
        return ctc_beta_ref(emit, allow_skip, in_lens, label_lens)
    out = _launch("ctc_beta", emit, allow_skip,
                  [("in_lens", in_lens), ("label_lens", label_lens)])
    ctc_beta.launches += 1
    return out


ctc_beta.launches = 0


# --------------------------------------------------------------------------- #
# The NLL with its custom backward
# --------------------------------------------------------------------------- #
def nll_from_alpha(alpha: torch.Tensor, in_lens: torch.Tensor,
                   label_lens: torch.Tensor) -> torch.Tensor:
    """(B,) NLL read from α at t = in_len − 1 (0 if in_len is 0): the last
    label state 2L−1 (when L > 0) and the last blank 2L."""
    B = alpha.shape[0]
    rows = torch.arange(B, device=alpha.device)
    a_T = alpha[rows, torch.clamp(in_lens.to(torch.int64) - 1, min=0)]     # (B, S)
    ll = label_lens.to(torch.int64)
    a_label = a_T[rows, torch.clamp(2 * ll - 1, min=0)]
    a_label = torch.where(ll > 0, a_label, torch.full_like(a_label, NEG))
    a_blank = a_T[rows, 2 * ll]
    return -torch.logaddexp(a_label, a_blank)


class _CTCLattice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, log_probs, in_lens, labels, label_lens, blank_id):
        ext = expand_labels(labels, blank_id)
        allow_skip = skip_allowed(ext, blank_id)
        emit = emit_log_probs(log_probs, ext).to(torch.float32).contiguous()
        alpha = ctc_alpha(emit, allow_skip, in_lens)
        nll = nll_from_alpha(alpha, in_lens, label_lens)
        ctx.save_for_backward(ext, allow_skip, emit, alpha, in_lens, label_lens, nll)
        ctx.vocab = log_probs.shape[2]
        ctx.lp_dtype = log_probs.dtype
        return nll

    @staticmethod
    def backward(ctx, g):
        ext, allow_skip, emit, alpha, in_lens, label_lens, nll = ctx.saved_tensors
        B, T, S = emit.shape
        beta = ctc_beta(emit, allow_skip, in_lens, label_lens)
        log_z = -nll
        gamma = torch.exp(torch.clamp(alpha + beta - emit - log_z[:, None, None], -80.0, 80.0))
        t_idx = torch.arange(T, device=emit.device)[None, :, None]
        gamma = torch.where(t_idx < in_lens[:, None, None], gamma, torch.zeros_like(gamma))
        idx = ext.to(torch.int64)[:, None, :].expand(B, T, S)
        dlogp = torch.zeros((B, T, ctx.vocab), dtype=torch.float32, device=emit.device)
        dlogp.scatter_add_(2, idx, gamma)
        dlogp = -dlogp * g.to(torch.float32)[:, None, None]
        return dlogp.to(ctx.lp_dtype), None, None, None, None


def ctc_nll_pallas(log_probs: torch.Tensor, in_lens: torch.Tensor, labels: torch.Tensor,
                   label_lens: torch.Tensor, blank_id: int = 0) -> torch.Tensor:
    """Per-example CTC NLL (B,) over log-probs (B, T, V) through the α/β
    lattice kernels (K3 forward, K4 backward), in float32."""
    return _CTCLattice.apply(log_probs, in_lens, labels, label_lens, blank_id)
