"""LucyRNN: the 7-gate gated linear-recurrent encoder, in PyTorch.

Port of ``statecatcher_tpu/models/lucyrnn.py`` (reference
lucyrnn_triton.py semantics):

  gates    g = W x + b           split into r, z, k, v, h_pre, decay, alpha
  grouped RMS + squash (ops/lucy_gates.py), then the two recurrences
             s_t = decay_t · s_{t-1} + alpha_t · kv_t
             c_t = tanh(h_pre_t/rms_h + s_t)
             h_t = z_t · h_{t-1} + (1 − z_t) · c_t

Per-track layer stacks with the inter-layer LayerNorm (eps 1e-5), optional
multi-track merge projection, zero-init output projection; carried state per
track/layer is (h = last output, s = final scan state), batch-major
``(B, tracks, L, D)``.

Each layer's recurrence runs one of four ways, as in the JAX package
(``cell_route``):

  * "k12" (``kernel_impl`` "pallas-fused" or "auto-fused", masked or not):
    the bias added in the gates' dtype, then the fused masked cell K12 (gate
    chain and both scans in one kernel; ``ops/lucy_pallas.py:lucy_fused_cell``,
    backward through K5b);
  * "dual" ("pallas-dual"): the gate chain in torch (``ops/lucy_gates.py``),
    then the dual scan K11 (s-scan, tanh and h-scan in one kernel;
    ``ops/lucy_pallas.py:lucy_dual_scan``, backward through K5b);
  * "fused" (every other scan algorithm without a frame mask): the fused
    lane-major cell (``ops/lucy_fused_lm.py``: K1 forward, K2 backward);
  * "split" (a frame mask, ``mask_state_updates=True``, or ``kernel_impl=
    "pallas"``): the gate chain in torch, then the s-scan, tanh and the
    h-scan, each scan K5 (``ops/lucy_pallas.py``).

The card runs the kernels, the CPU their plain versions.  ``kernel_impl=
"sp"`` (the sequence-parallel scan, multi-GPU) is not ported and raises on
the card.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from statecatcher_tpu_torch.config import LucyRNNConfig
from statecatcher_tpu_torch.models.layers import Dense, LayerNorm, xavier_uniform_
from statecatcher_tpu_torch.ops.lucy_fused_lm import lucy_cell_fused_lm
from statecatcher_tpu_torch.ops.lucy_gates import lucy_gate_coeffs
from statecatcher_tpu_torch.ops.lucy_pallas import lucy_dual_scan, lucy_fused_cell
from statecatcher_tpu_torch.ops.scan import SCAN_IMPLS, linear_scan

# kernel_impl values whose TPU kernels are not ported yet → ROADMAP.md row
_UNPORTED = {"sp": "multi-GPU (ops/scan_sp.py, the sequence-parallel scan)"}
_K12_IMPLS = ("pallas-fused", "auto-fused")


def cell_route(impl: str, on_cuda: bool, masked: bool) -> str:
    """How ``lucy_cell_parallel`` runs a segment, in the JAX package's order:
    "k12" (the fused masked cell) for "pallas-fused" and "auto-fused",
    masked or not; "dual" (gate chain, then the dual scan K11) for
    "pallas-dual"; then "split" (gate chain, then the two scans through K5)
    with a frame mask or for "pallas", and "fused" (K1/K2) for every other
    scan algorithm (they compute the same recurrence).  "sp", whose kernel
    is not ported, raises on the card rather than fall back; on the CPU it
    runs the same function's plain version."""
    if impl not in SCAN_IMPLS and impl not in _K12_IMPLS and impl != "pallas-dual" \
            and not impl.startswith("fused-lm"):
        raise ValueError(f"Unknown kernel_impl {impl!r}")
    if on_cuda and impl in _UNPORTED:
        raise NotImplementedError(
            f"kernel_impl={impl!r} is not ported to CUDA yet: see ROADMAP.md, "
            f"{_UNPORTED[impl]}")
    if impl in _K12_IMPLS:
        return "k12"
    if impl == "pallas-dual":
        return "dual"
    return "split" if masked or impl == "pallas" else "fused"


def lucy_cell_parallel(
    gates: torch.Tensor,                        # lane-major (B, T, 7·D)
    h0: torch.Tensor,                           # (B, D)
    s0: torch.Tensor,                           # (B, D)
    impl: str = "auto",
    frame_mask: Optional[torch.Tensor] = None,  # (B, T) bool
    bias: Optional[torch.Tensor] = None,        # (7·D,) gate bias
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run the 7-gate cell over a whole segment → (h_all, h_T, s_T).

    With ``frame_mask``, masked steps leave (h, s) unchanged: their scan
    coefficients are the identity map (a = 1, b = 0)."""
    route = cell_route(impl, gates.is_cuda, frame_mask is not None)   # raises if unported
    if route == "k12":
        # the bias added in the gates' dtype (under bf16 the sum is rounded
        # to bf16 before the gate chain), then the (B, T, 7, D) view
        if bias is not None:
            gates = gates + bias.to(gates.dtype)
        B, T, G = gates.shape
        h_all, s_all = lucy_fused_cell(gates.reshape(B, T, 7, G // 7), h0, s0, frame_mask)
        return h_all, h_all[:, -1, :], s_all[:, -1, :]
    if route == "dual":
        a_s, b_s, a_h, _, h_pre_n = lucy_gate_coeffs(gates, frame_mask, bias)
        h_all, s_all = lucy_dual_scan(a_s, b_s, a_h, h_pre_n, h0, s0)
        return h_all, h_all[:, -1, :], s_all[:, -1, :]
    if bias is None:
        bias = torch.zeros(gates.shape[-1], dtype=torch.float32, device=gates.device)
    if route == "fused":
        # differentiable through K1/K2 on the card, their plain versions on the CPU
        h_all, s_all = lucy_cell_fused_lm(gates, bias, h0, s0)
    else:
        # differentiable through torch's autograd and K5a/K5b
        scan = impl if impl in SCAN_IMPLS else "auto"
        a_s, b_s, a_h, bh_c, h_pre_n = lucy_gate_coeffs(gates, frame_mask, bias)
        s_all = linear_scan(a_s, b_s, s0, impl=scan)
        c = torch.tanh(h_pre_n + s_all)
        h_all = linear_scan(a_h, bh_c * c, h0, impl=scan)
    return h_all, h_all[:, -1, :], s_all[:, -1, :]


def _gate_bias_init(d: int, dtype: torch.dtype) -> torch.Tensor:
    """Gate-aware bias (reference lucyrnn_triton.py:39-48):
    r=0, z=1, k=0, v=0, h_pre=0, decay=2, alpha=0.5."""
    vals = [0.0, 1.0, 0.0, 0.0, 0.0, 2.0, 0.5]
    return torch.tensor(vals, dtype=dtype).repeat_interleave(d)


class GateProj(nn.Module):
    """Fused gate projection that returns the bias UNAPPLIED: the kernel adds
    it while it reads the gates, so no (B, T, 7D) pass is spent on it."""

    def __init__(self, in_features: int, features: int, *, dtype: torch.dtype,
                 param_dtype: torch.dtype, generator: torch.Generator):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features, dtype=param_dtype))
        xavier_uniform_(self.weight, generator)
        self.bias = nn.Parameter(_gate_bias_init(features // 7, param_dtype))

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        y = torch.matmul(x.to(self.dtype), self.weight.to(self.dtype).t())
        return y, self.bias


class LucyCell(nn.Module):
    """One LucyRNN layer: fused 7-gate projection + the recurrence."""

    def __init__(self, in_features: int, hidden_dim: int, kernel_impl: str, *,
                 dtype: torch.dtype, param_dtype: torch.dtype,
                 generator: torch.Generator):
        super().__init__()
        self.kernel_impl = kernel_impl
        self.gate_proj = GateProj(in_features, 7 * hidden_dim, dtype=dtype,
                                  param_dtype=param_dtype, generator=generator)

    def forward(self, x, h0, s0, frame_mask=None):
        gates, bias = self.gate_proj(x)
        return lucy_cell_parallel(
            gates, h0.to(gates.dtype), s0.to(gates.dtype),
            impl=self.kernel_impl, frame_mask=frame_mask, bias=bias)


class LucyRNNEncoder(nn.Module):
    """Multi-track, multi-layer LucyRNN with the vocab output projection.

    Submodule names follow the flax tree (``track{t}_layer{l}``,
    ``track{t}_norm{l}``, ``merge_proj``, ``output_proj``).
    """

    def __init__(self, input_dim: int, vocab_size: int, cfg: LucyRNNConfig, *,
                 dtype: torch.dtype, param_dtype: torch.dtype,
                 generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        D = cfg.hidden_dim
        for t in range(cfg.num_tracks):
            for l in range(cfg.num_layers):
                self.add_module(f"track{t}_layer{l}", LucyCell(
                    input_dim if l == 0 else D, D, cfg.kernel_impl, dtype=dtype,
                    param_dtype=param_dtype, generator=generator))
                if l < cfg.num_layers - 1:
                    # eps 1e-5: torch's LayerNorm default, as in the reference
                    self.add_module(f"track{t}_norm{l}", LayerNorm(
                        D, eps=1e-5, dtype=dtype, param_dtype=param_dtype))
        if cfg.num_tracks > 1:
            self.merge_proj = Dense(D * cfg.num_tracks, D, dtype=dtype,
                                    param_dtype=param_dtype, generator=generator,
                                    kernel_init=xavier_uniform_)
        # zero-init output projection (reference lucyrnn_triton.py:107-109)
        self.output_proj = Dense(D, vocab_size, dtype=dtype, param_dtype=param_dtype,
                                 generator=generator, kernel_init=None)

    def init_state(self, batch_size: int) -> dict:
        cfg = self.cfg
        shape = (batch_size, cfg.num_tracks, cfg.num_layers, cfg.hidden_dim)
        dev = self.output_proj.weight.device
        return {"h": torch.zeros(shape, dtype=self.dtype, device=dev),
                "s": torch.zeros(shape, dtype=self.dtype, device=dev)}

    def forward(self, x, state=None, frame_mask=None):
        cfg = self.cfg
        if state is None:
            state = self.init_state(x.shape[0])
        cell_mask = frame_mask if cfg.mask_state_updates else None

        track_outputs, new_h, new_s = [], [], []
        for t in range(cfg.num_tracks):
            x_t = x
            h_layers, s_layers = [], []
            for l in range(cfg.num_layers):
                cell = getattr(self, f"track{t}_layer{l}")
                x_t, h_T, s_T = cell(x_t, state["h"][:, t, l], state["s"][:, t, l],
                                     cell_mask)
                h_layers.append(h_T)
                s_layers.append(s_T)
                if l < cfg.num_layers - 1:
                    x_t = getattr(self, f"track{t}_norm{l}")(x_t)
            track_outputs.append(x_t)
            new_h.append(torch.stack(h_layers, dim=1))     # (B, L, D)
            new_s.append(torch.stack(s_layers, dim=1))

        if cfg.num_tracks == 1:
            y = track_outputs[0]
        else:
            y = self.merge_proj(torch.cat(track_outputs, dim=-1))
        logits = self.output_proj(y)
        new_state = {"h": torch.stack(new_h, dim=1),        # (B, tracks, L, D)
                     "s": torch.stack(new_s, dim=1)}
        return logits, new_state
