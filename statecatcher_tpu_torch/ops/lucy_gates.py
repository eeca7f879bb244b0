"""LucyRNN gate chain: raw gates → the two scans' coefficients.

Port of ``statecatcher_tpu/ops/lucy_pallas.py:lucy_gate_coeffs`` (reference
lucyrnn_triton.py:214-226 semantics), in the same sqrt/divide form as that
XLA path.  (The JAX fused kernel writes the chain as rsqrt products,
``ops/lucy_fused_lm.py:_gate_chain_res``; the two agree to about 1 ulp.)
"""

from __future__ import annotations

from typing import Optional

import torch

EPS = 1e-6


def lucy_gate_coeffs(gates: torch.Tensor, frame_mask: Optional[torch.Tensor] = None,
                     bias: Optional[torch.Tensor] = None):
    """Lane-major gates (B, T, 7·D), bias unapplied → (a_s, b_s, a_h, bh_c,
    h_pre_n), each (B, T, D) in the gates' dtype.

    Gate order r, z, k, v, h_pre, decay, alpha; grouped RMS normalisation
    with ε = 1e-6; ``bh_c`` is (1 − z_n), the h-scan's offset before it is
    multiplied by c.  With ``frame_mask`` (B, T), masked steps become the
    identity map (a = 1, b = 0).
    """
    D = gates.shape[-1] // 7

    def gate(i):
        x = gates[..., i * D:(i + 1) * D]
        if bias is not None:
            x = x + bias[i * D:(i + 1) * D].to(x.dtype)
        return x

    r, z, k, v, h_pre, decay, alpha = (gate(i) for i in range(7))
    rms_rz = torch.sqrt((r.square() + z.square()) / 2 + EPS)
    rms_kv2 = (k.square() + v.square()) / 2 + EPS
    rms_kv = torch.sqrt(rms_kv2)
    rms_d = torch.sqrt(decay.square() + EPS)
    rms_a = torch.sqrt(alpha.square() + EPS)
    rms_h = torch.sqrt(h_pre.square() + EPS)
    z_n = torch.sigmoid(z / rms_rz)
    decay_n = torch.sigmoid(decay / rms_d)
    alpha_n = torch.sigmoid(alpha / rms_a)
    h_pre_n = h_pre / rms_h
    kv = (k / rms_kv) * (v / rms_kv) / (rms_kv2 + EPS)
    a_s = decay_n
    b_s = alpha_n * kv
    a_h = z_n
    bh_c = 1.0 - z_n
    if frame_mask is not None:
        m = frame_mask[..., None].to(a_s.dtype)
        a_s = m * a_s + (1.0 - m)
        b_s = m * b_s
        a_h = m * a_h + (1.0 - m)
        bh_c = m * bh_c
    return a_s, b_s, a_h, bh_c, h_pre_n
