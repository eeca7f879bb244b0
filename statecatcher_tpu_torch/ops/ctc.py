"""CTC loss with PyTorch-parity normalisation.

Port of ``statecatcher_tpu/ops/ctc.py``: per-example NLL / max(label_len, 1),
and ``zero_infinity`` zeroes non-finite values and values ≥ 1e29 (an
unalignable row).  The log-softmax runs in at least float32.

NLL implementations (``impl``):

  * "pallas" — the α/β lattice kernels K3/K4 (``ops/ctc_lattice.py``) on a
    CUDA tensor, their plain versions on the CPU; float32 throughout.
  * "auto"   — "pallas" on a CUDA tensor, "lattice" on the CPU.
  * "lattice" — the plain α recursion below, differentiated by autograd, in
    the log-probs' dtype (float64 stays float64).
  * "optax"  — the JAX package's optax CTC; the port has no optax, so this
    runs "lattice", which computes the same NLL.
"""

from __future__ import annotations

import torch

from statecatcher_tpu_torch.ops.ctc_lattice import (
    NEG,
    ctc_nll_pallas,
    emit_log_probs,
    expand_labels,
    skip_allowed,
)

__all__ = ["ctc_loss_per_example", "ctc_nll_lattice", "emit_log_probs",
           "expand_labels"]


def ctc_nll_lattice(log_probs: torch.Tensor, in_lens: torch.Tensor, labels: torch.Tensor,
                    label_lens: torch.Tensor, blank_id: int = 0) -> torch.Tensor:
    """Per-example CTC NLL via the log-space α recursion over the 2U+1
    extended labels, frozen past each row's ``in_len``:
    α_t(s) = logp_t(l_s) + logaddexp(α(s), α(s−1), α(s−2) if the skip is
    allowed)."""
    B, T, V = log_probs.shape
    S = 2 * labels.shape[1] + 1
    dt, dev = log_probs.dtype, log_probs.device
    ext = expand_labels(labels, blank_id)
    allow_skip = skip_allowed(ext, blank_id)
    # one (B, S) view per frame: unbind's backward stacks their gradients
    # once, where indexing emit[:, t] would add a full (B, T, S) gradient
    # per step
    emit = emit_log_probs(log_probs, ext).unbind(1)         # T × (B, S)
    col = torch.full((B, 1), NEG, dtype=dt, device=dev)
    has_label = label_lens > 0

    alpha = torch.cat([emit[0][:, :1],
                       torch.where(has_label, emit[0][:, 1], col[:, 0])[:, None],
                       col.expand(B, S - 2)], dim=1) if S > 1 else emit[0][:, :1]
    for t in range(1, T):
        adv = torch.cat([col, alpha[:, :-1]], dim=1)
        skip = torch.cat([col, col, alpha[:, :-2]], dim=1)[:, :S]
        skip = torch.where(allow_skip, skip, col)
        new = torch.logaddexp(torch.logaddexp(alpha, adv), skip) + emit[t]
        alpha = torch.where((t < in_lens)[:, None], new, alpha)

    rows = torch.arange(B, device=dev)
    ll = label_lens.to(torch.int64)
    a_label = torch.where(has_label, alpha[rows, torch.clamp(2 * ll - 1, min=0)], col[:, 0])
    a_blank = alpha[rows, 2 * ll]
    return -torch.logaddexp(a_label, a_blank)


def ctc_loss_per_example(logits: torch.Tensor, in_lens: torch.Tensor, labels: torch.Tensor,
                         label_lens: torch.Tensor, blank_id: int = 0,
                         zero_infinity: bool = True, impl: str = "lattice") -> torch.Tensor:
    """Per-example CTC loss (B,), PyTorch-normalised (nll / max(label_len, 1)),
    from raw logits (B, T, V)."""
    acc = torch.promote_types(logits.dtype, torch.float32)
    log_probs = torch.log_softmax(logits.to(acc), dim=-1)
    if impl == "auto":
        impl = "pallas" if log_probs.is_cuda else "lattice"
    if impl in ("lattice", "optax"):
        nll = ctc_nll_lattice(log_probs, in_lens, labels, label_lens, blank_id)
    elif impl == "pallas":
        nll = ctc_nll_pallas(log_probs, in_lens, labels, label_lens, blank_id)
    else:
        raise ValueError(f"Unknown CTC impl {impl!r}")
    per = nll / torch.clamp(label_lens, min=1).to(nll.dtype)
    if zero_infinity:
        per = torch.where(torch.isfinite(per) & (per < 1e29), per, torch.zeros_like(per))
    return per
