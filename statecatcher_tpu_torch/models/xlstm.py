"""xLSTM encoder: mLSTM blocks with chunkwise-parallel matrix memory.

Port of ``statecatcher_tpu/models/xlstm.py``: per head an exponentially
gated matrix memory C ∈ R^{dqk×dv} with normaliser n and max-state m,
computed chunk by chunk (attention-shaped inside a chunk, the (C, n, m)
state carried across chunks); a block is a pre-norm mLSTM mixer and a
pre-norm SwiGLU FFN, each residual.  The carried state per block is
(C, n, m), batch-major: {"C": (B, blocks, H, dqk, dv), "n": (B, blocks, H,
dqk), "m": (B, blocks, H)}.

``XLSTMConfig.kernel_impl`` picks the recurrence:

  * "auto": "fused" on the card, "chunkwise" on the CPU (the JAX package's
    CPU path);
  * "fused": ``ops/mlstm_fused.py`` (K9a forward, K9b backward on the card);
  * "pallas": ``ops/mlstm_pallas.py`` (K10 forward on the card, the backward
    autograd of ``mlstm_chunkwise``);
  * "chunkwise", "recurrent": plain torch on either device (no TPU kernel
    stands behind them).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from statecatcher_tpu_torch.config import XLSTMConfig
from statecatcher_tpu_torch.models.layers import Dense, RMSNorm
from statecatcher_tpu_torch.ops.mlstm_fused import NEG, mlstm_fused, soft_cap
from statecatcher_tpu_torch.ops.mlstm_pallas import mlstm_chunkwise_pallas

KERNEL_IMPLS = ("auto", "chunkwise", "recurrent", "pallas", "fused")


def resolve_kernel_impl(impl: str, on_cuda: bool) -> str:
    """"auto" → "fused" on the card, "chunkwise" on the CPU."""
    if impl not in KERNEL_IMPLS:
        raise ValueError(f"Unknown xLSTM kernel_impl {impl!r} (expected {'|'.join(KERNEL_IMPLS)})")
    if impl == "auto":
        return "fused" if on_cuda else "chunkwise"
    return impl


def mlstm_recurrent(q, k, v, i_raw, f_raw, C0, n0, m0, gate_soft_cap: float = 15.0):
    """Step-by-step stabilised mLSTM: q, k (B, H, T, dqk), v (B, H, T, dv),
    gates (B, H, T), carry (C0, n0, m0) → (h (B, H, T, dv), C_T, n_T, m_T).
    The chunkwise form with chunks of one step."""
    q = q * q.shape[-1] ** -0.5
    i_c = soft_cap(i_raw, gate_soft_cap)
    logf = F.logsigmoid(soft_cap(f_raw, gate_soft_cap))
    C, n, m = C0, n0, m0
    hs = []
    for t in range(q.shape[2]):
        qt, kt, vt, it, lft = q[:, :, t], k[:, :, t], v[:, :, t], i_c[..., t], logf[..., t]
        m_new = torch.maximum(lft + m, it)
        decay = torch.exp(lft + m - m_new)[..., None]
        write = torch.exp(it - m_new)[..., None]
        C = decay[..., None] * C + (kt * write)[..., None] * vt[..., None, :]
        n = decay * n + kt * write
        qn = (qt * n).sum(-1)
        num = torch.einsum("bhd,bhdv->bhv", qt, C)
        denom = torch.maximum(qn.abs(), torch.exp(-m_new))[..., None]
        hs.append(num / denom)
        m = m_new
    return torch.stack(hs, 2), C, n, m


def mlstm_chunkwise(q, k, v, i_raw, f_raw, C0, n0, m0, chunk_size: int,
                    gate_soft_cap: float = 15.0):
    """Chunkwise-parallel stabilised mLSTM, the JAX package's
    ``mlstm_chunkwise``: shapes as ``mlstm_recurrent``.  T is padded to a
    chunk multiple (q, k, v with 0, the raw input gate with −1e30 and the
    raw forget gate with +30, before the soft cap).  The products take their
    operands in q's dtype (bf16 under a bf16 model) and sum in float32; the
    gating arithmetic is float32.  h comes out in q's dtype."""
    B, H, T, dqk = q.shape
    L = chunk_size
    pad = (-T) % L
    if pad:
        q, k, v = (F.pad(x, (0, 0, 0, pad)) for x in (q, k, v))
        i_raw = F.pad(i_raw, (0, pad), value=NEG)
        f_raw = F.pad(f_raw, (0, pad), value=30.0)
    md = q.dtype
    cdt = torch.promote_types(md, torch.float32)
    q = q * dqk ** -0.5
    i_c = soft_cap(i_raw, gate_soft_cap)
    logf = F.logsigmoid(soft_cap(f_raw, gate_soft_cap))

    def mm(x, y):          # operands in the model dtype, float32 sums
        return torch.matmul(x.to(md).to(cdt), y.to(md).to(cdt))

    tri = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
    C, n, m = C0, n0, m0
    hs = []
    for c in range((T + pad) // L):
        sl = slice(c * L, (c + 1) * L)
        qc, kc, vc, ic, lfc = q[:, :, sl], k[:, :, sl], v[:, :, sl], i_c[..., sl], logf[..., sl]
        b = torch.cumsum(lfc, -1)
        a = ic - b
        bL = b[..., -1]
        R = torch.where(tri, a[..., None, :], NEG).amax(-1)     # max_{s≤t} a_s
        mu = b + torch.maximum(m[..., None], R)
        D = torch.where(tri, b[..., :, None] + a[..., None, :] - mu[..., :, None], NEG)
        E = torch.exp(D)
        W = mm(qc, kc.transpose(-1, -2)) * E
        sp = torch.exp(b + m[..., None] - mu)
        num = mm(W, vc) + mm(qc, C) * sp[..., None]
        nvec = mm(E, kc) + n[..., None, :] * sp[..., None]
        qn = (qc.to(cdt) * nvec).sum(-1)
        h = num / torch.maximum(qn.abs(), torch.exp(-mu))[..., None]

        m_new = torch.maximum(m + bL, bL + R[..., -1])
        g = torch.exp(m + bL - m_new)
        w = torch.exp(bL[..., None] + a - m_new[..., None])
        kw = kc * w[..., None].to(md)
        C = g[..., None, None] * C + mm(kw.transpose(-1, -2), vc)
        n = g[..., None] * n + kw.to(cdt).sum(-2)
        m = m_new
        hs.append(h.to(md))
    return torch.cat(hs, 2)[:, :, :T], C, n, m


class MLSTMLayer(nn.Module):
    """Multi-head mLSTM mixer with output gate and per-head RMS norm:
    q, k, v, ogate and out_proj without bias; the gate biases start at −10
    (input) and +3 (forget)."""

    def __init__(self, E: int, H: int, cfg: XLSTMConfig, *, dtype: torch.dtype,
                 param_dtype: torch.dtype, generator: torch.Generator):
        super().__init__()
        self.H = H
        self.dqk = int(E * cfg.qk_dim_factor) // H
        self.dv = int(E * cfg.v_dim_factor) // H
        self.chunk_size = cfg.chunk_size
        self.gate_soft_cap = cfg.gate_soft_cap
        self.kernel_impl = cfg.kernel_impl
        self.dtype = dtype

        def dense(out, bias=False):
            return Dense(E, out, dtype=dtype, param_dtype=param_dtype, generator=generator,
                         use_bias=bias)

        self.q = dense(H * self.dqk)
        self.k = dense(H * self.dqk)
        self.v = dense(H * self.dv)
        self.igate = dense(H, bias=True)
        self.fgate = dense(H, bias=True)
        with torch.no_grad():
            self.igate.bias.fill_(-10.0)
            self.fgate.bias.fill_(3.0)
        self.head_norm = RMSNorm(self.dv, dtype=dtype, param_dtype=param_dtype)
        self.ogate = dense(H * self.dv)
        self.out_proj = Dense(H * self.dv, E, dtype=dtype, param_dtype=param_dtype,
                              generator=generator, use_bias=False)

    def forward(self, x: torch.Tensor, state: dict) -> tuple[torch.Tensor, dict]:
        B, T, E = x.shape
        H, dqk, dv = self.H, self.dqk, self.dv
        impl = resolve_kernel_impl(self.kernel_impl, x.is_cuda)
        q_lane, k_lane, v_lane = self.q(x), self.k(x), self.v(x)
        i_lane, f_lane = self.igate(x), self.fgate(x)
        sdt = torch.promote_types(self.dtype, torch.float32)
        C0, n0, m0 = (state[key].to(sdt) for key in ("C", "n", "m"))
        o = torch.sigmoid(self.ogate(x)).reshape(B, T, H, dv)
        if impl == "fused":
            # lane-major q/k/v/h: no head transposes
            h, C_T, n_T, m_T = mlstm_fused(q_lane, k_lane, v_lane, i_lane, f_lane, C0, n0, m0,
                                           self.chunk_size, self.gate_soft_cap)
            h = self.head_norm(h.to(self.dtype).reshape(B, T, H, dv))
        else:
            heads = lambda z, d: z.reshape(B, T, H, d).transpose(1, 2)
            q, k, v = heads(q_lane, dqk), heads(k_lane, dqk), heads(v_lane, dv)
            i_raw, f_raw = (z.transpose(1, 2).to(sdt) for z in (i_lane, f_lane))
            if impl != "chunkwise":
                # the chunkwise products keep the model dtype; the others f32
                q, k, v = (z.to(sdt) for z in (q, k, v))
            if impl == "recurrent":
                h, C_T, n_T, m_T = mlstm_recurrent(q, k, v, i_raw, f_raw, C0, n0, m0,
                                                   self.gate_soft_cap)
            elif impl == "pallas":
                h, C_T, n_T, m_T = mlstm_chunkwise_pallas(q, k, v, i_raw, f_raw, C0, n0, m0,
                                                          self.chunk_size, self.gate_soft_cap)
            else:
                h, C_T, n_T, m_T = mlstm_chunkwise(q, k, v, i_raw, f_raw, C0, n0, m0,
                                                   self.chunk_size, self.gate_soft_cap)
            h = self.head_norm(h.to(self.dtype)).transpose(1, 2)
        y = self.out_proj((h * o).reshape(B, T, H * dv))
        new_state = {"C": C_T.to(state["C"].dtype), "n": n_T.to(state["n"].dtype),
                     "m": m_T.to(state["m"].dtype)}
        return y, new_state


class SwiGLUFFN(nn.Module):
    """down(silu(gate(x)) · up(x)), no biases, d_ff = int(E · factor)."""

    def __init__(self, E: int, proj_factor: float, *, dtype: torch.dtype,
                 param_dtype: torch.dtype, generator: torch.Generator):
        super().__init__()
        d_ff = int(E * proj_factor)
        kw = dict(dtype=dtype, param_dtype=param_dtype, generator=generator, use_bias=False)
        self.gate = Dense(E, d_ff, **kw)
        self.up = Dense(E, d_ff, **kw)
        self.down = Dense(d_ff, E, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(F.silu(self.gate(x)) * self.up(x))


class XLSTMEncoder(nn.Module):
    """input_proj → blocks of (RMSNorm → mLSTM, residual; RMSNorm → SwiGLU,
    residual) → final RMSNorm → vocab_proj (zero at init)."""

    def __init__(self, input_dim: int, vocab_size: int, cfg: XLSTMConfig, *,
                 dtype: torch.dtype, param_dtype: torch.dtype, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        E, H = cfg.embedding_dim, cfg.num_heads
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        self.input_proj = Dense(input_dim, E, generator=generator, **kw)
        for bi in range(cfg.num_blocks):
            self.add_module(f"block{bi}_norm_mlstm", RMSNorm(E, **kw))
            self.add_module(f"block{bi}_mlstm", MLSTMLayer(E, H, cfg, generator=generator, **kw))
            self.add_module(f"block{bi}_norm_ffn", RMSNorm(E, **kw))
            self.add_module(f"block{bi}_ffn", SwiGLUFFN(E, cfg.ffn_proj_factor,
                                                        generator=generator, **kw))
        self.final_norm = RMSNorm(E, **kw)
        self.vocab_proj = Dense(E, vocab_size, generator=generator, kernel_init=None, **kw)

    def forward(self, x: torch.Tensor, state: Optional[dict] = None, frame_mask=None):
        """``(logits, new_state)``; ``frame_mask`` is not read (the ASR model
        zeroes masked inputs, as in the JAX package)."""
        cfg = self.cfg
        if state is None:
            state = xlstm_init_carry(cfg, x.shape[0], self.dtype, x.device)
        x = self.input_proj(x)
        new = {"C": [], "n": [], "m": []}
        for bi in range(cfg.num_blocks):
            block_state = {key: state[key][:, bi] for key in new}
            h, block_state = getattr(self, f"block{bi}_mlstm")(
                getattr(self, f"block{bi}_norm_mlstm")(x), block_state)
            x = x + h
            f = getattr(self, f"block{bi}_norm_ffn")(x)
            ffn = getattr(self, f"block{bi}_ffn")
            if cfg.ffn_remat and torch.is_grad_enabled():
                x = x + checkpoint(ffn, f, use_reentrant=False)
            else:
                x = x + ffn(f)
            for key in new:
                new[key].append(block_state[key])
        logits = self.vocab_proj(self.final_norm(x))
        return logits, {key: torch.stack(v, 1) for key, v in new.items()}


def xlstm_init_carry(cfg: XLSTMConfig, batch_size: int, dtype=torch.float32,
                     device="cpu") -> dict:
    """Zero carry: {"C": (B, blocks, H, dqk, dv), "n": (B, blocks, H, dqk),
    "m": (B, blocks, H)}."""
    E, H, nb = cfg.embedding_dim, cfg.num_heads, cfg.num_blocks
    dqk = int(E * cfg.qk_dim_factor) // H
    dv = int(E * cfg.v_dim_factor) // H
    z = lambda *shape: torch.zeros((batch_size, nb, H, *shape), dtype=dtype, device=device)
    return {"C": z(dqk, dv), "n": z(dqk), "m": z()}
