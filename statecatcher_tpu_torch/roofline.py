"""Analytic speed-of-light model of the training step on an NVIDIA H100.

Port of ``statecatcher_tpu/roofline.py``: from the model config, the FLOPs
and the principal HBM bytes one audio-second of training costs, and the
throughput the card could reach at its peaks.  ``Roofline.mfu`` is model
FLOPs over the bf16 tensor-core peak, whatever the model's dtype (the
industry convention, as ``bench.py``'s ``mfu``); ``Roofline.pct_sol`` is
achieved over roofline throughput, where the roofline time of an
audio-second is max(compute time, memory time, exp time): the
overlapped-roofline bound.

The card's rates, from NVIDIA's H100 SXM5 data sheet (the card the port
runs on is an "NVIDIA H100 80GB HBM3" at 700 W), dense:

  H100_PEAK_FLOPS_BF16  989e12  bf16 on the tensor cores
  H100_PEAK_FLOPS_TF32  495e12  TF32 on the tensor cores
  H100_PEAK_FLOPS_F32    67e12  float32 outside the tensor cores
  H100_PEAK_HBM_BPS     3.35e12 HBM3
  H100_EXP_PER_S       ~4.18e12 the SFU's exps: 16 a clock on each of the
                                132 SMs at the highest SM clock, 1.98 GHz
                                (``chip_smoke.py:joint_fwd_yardsticks``
                                reads the card's own clock with nvidia-smi)

``flops_per_audio_sec`` follows the model convention of the JAX module:
products only (gate and output projections, the CTC emission term 2·V·S,
the RNN-T joint over all U+1 label positions), the backward twice the
forward.  ``bytes_per_audio_sec`` is its principal HBM traffic: each
principal intermediate once per producer and consumer (gate tensors, scan
inputs and outputs in f32, encoder activations, logits in f32, the
lattices' tables) and Adam's f32 p, g, m, v read and p, m, v written once a
segment, spread over the segment's audio.  Elementwise work is counted by
its bytes, not its operations.  The RWKV's products are the JAX module's
coarse eight gate-widths a layer.

Where the JAX module's product count contradicts the model that both
packages build, this module counts the model (each difference is listed in
ROADMAP.md §3 with its test, ``tests/test_torch_roofline.py``):

  * the xLSTM has ``xlstm.num_blocks`` blocks, not ``num_layers``;
  * the LSTM's recurrent product h·w_hh, (B, D)×(D, 4D) a frame and layer,
    and its w_hh among the parameters;
  * the optional input projection (``input_proj_dim`` > 0), and the
    encoder's input width taken from it;
  * the 6-gate native LucyRNN: each layer's input projection to D, then
    five D×D products (``fused_ops``: one D×6D); its parameters, W_r's too;
  * the RNN-T joiner's encoder projection (V×J a frame) and predictor
    projection (E×J a label), and its parameters;
  * the 7-gate LucyRNN's ``num_tracks`` stacks and their merge projection.

The speed-of-light bound is the card's: ``t_flops`` sums each family of
products at the rate the port runs it,

  * the encoder's and the projections' ``torch.matmul`` GEMMs at the bf16
    peak for a bf16 model, at the f32 peak for an f32 one (the port leaves
    TF32 off: ``frontend.py``);
  * the RNN-T joint, K6/K8, at the bf16 peak, or for f32 at 3xTF32's, a
    third of the TF32 peak: 8·W·J·V a frame (the forward's 2J and the
    backward's 6J per window cell, the logits recomputed), W = U+1 for the
    exact joint and ``ops/rnnt_band.band_width`` for the banded one, with
    no padding (``chip_smoke.py:joint_bound_ms`` counts the same);
  * the mLSTM mixer, K9/K10, at the same pair of rates;

while the CTC emission term stays out of the executed work (the port forms
the emissions by a gather, ``ops/ctc_lattice.py``).  ``t_bytes`` is the
bytes over ``H100_PEAK_HBM_BPS``; ``t_exp`` is the joint's 2·W·V exps a
frame (forward and the backward's recompute) at ``H100_EXP_PER_S``.
``peak_flops`` given puts every family at that one rate, as the JAX
module does.  The arithmetic is plain Python: the module imports no torch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from statecatcher_tpu_torch.config import Config

H100_PEAK_FLOPS_BF16 = 989e12
H100_PEAK_FLOPS_TF32 = 495e12
H100_PEAK_FLOPS_F32 = 67e12
H100_PEAK_HBM_BPS = 3.35e12
H100_SMS = 132
H100_MAX_SM_CLOCK_HZ = 1.98e9
H100_EXP_PER_S = 16 * H100_SMS * H100_MAX_SM_CLOCK_HZ


@dataclass
class Roofline:
    flops_per_audio_sec: float        # model FLOPs (fwd+bwd)
    bytes_per_audio_sec: float        # principal HBM traffic
    sol_audio_sec_per_sec: float      # overlapped-roofline throughput bound

    def mfu(self, achieved_audio_sec_per_sec: float,
            peak_flops: float = H100_PEAK_FLOPS_BF16) -> float:
        return achieved_audio_sec_per_sec * self.flops_per_audio_sec / peak_flops

    def pct_sol(self, achieved_audio_sec_per_sec: float) -> float:
        return achieved_audio_sec_per_sec / self.sol_audio_sec_per_sec


def _xlstm_dims(m) -> tuple[int, int, int, int, int, int, int]:
    """(E, heads, blocks, dqk, dv, chunk, d_ff) of the xLSTM."""
    x = m.xlstm
    E, H = x.embedding_dim, x.num_heads
    return (E, H, x.num_blocks, int(E * x.qk_dim_factor) // H, int(E * x.v_dim_factor) // H,
            x.chunk_size, int(E * x.ffn_proj_factor))


def _encoder(cfg: Config, din0: int) -> tuple[float, float, float, int, int]:
    """(forward GEMM FLOPs a frame with the output projection, forward mLSTM
    mixer FLOPs a frame, parameters, gate planes a layer, layers) of the
    encoder fed ``din0`` features a frame."""
    m = cfg.model
    D, L, V = m.hidden_size, m.num_layers, m.vocab_size
    if m.encoder == "xlstm":
        E, H, nb, dqk, dv, Lc, dff = _xlstm_dims(m)
        # per block: q, k, v, ogate, the two gates, out_proj; SwiGLU's three
        proj = 2 * E * (2 * H * dqk + 2 * H * dv + 2 * H) + 2 * (H * dv) * E
        ffn = 6 * E * dff
        # chunkwise mixer, executed FLOPs a frame (the L² terms ÷ Lc): S = q·kᵀ,
        # expD·k, W·v and the two state-sized products q·C and (k·w)·vᵀ
        mixer = 2 * H * (Lc * dqk + Lc * dqk + Lc * dv + 2 * dqk * dv)
        gemm = nb * (proj + ffn) + 2 * din0 * E + 2 * E * V
        params = (din0 * E + E * V
                  + nb * (E * (2 * H * dqk + 2 * H * dv + 2 * H) + H * dv * E + 3 * E * dff))
        return gemm, nb * mixer, params, 0, nb
    if m.encoder == "lucyrnn" and m.lucyrnn.variant == "native":
        # each layer: input_proj to D, then W_z, W_k, W_v, W_decay and W_h
        # (W_r is built but unused) or, fused, one D×6D; six D×D of weights
        n = 6 if m.lucyrnn.fused_ops else 5
        gemm = params = 0
        for l in range(L):
            din = din0 if l == 0 else D
            gemm += 2 * din * D + 2 * n * D * D
            params += din * D + 6 * D * D
        return gemm + 2 * D * V, 0, params + D * V, 6, L
    if m.encoder == "lucyrnn":
        gates, tracks = 7, m.lucyrnn.num_tracks
    elif m.encoder == "lstm":
        gates, tracks = 4, 1
    elif m.encoder == "rwkv":
        gates, tracks = 8, 1        # q/k/v/gates + ffn, coarse
    else:
        raise ValueError(f"no roofline for encoder {m.encoder!r}")
    track = din0 * gates * D + (L - 1) * D * gates * D
    if m.encoder == "lstm":
        track += L * D * gates * D                    # h·w_hh, every frame and layer
    merge = tracks * D * D if tracks > 1 else 0
    gemm = 2 * (tracks * track + merge + D * V)
    return gemm, 0, tracks * track + merge + D * V, gates, L * tracks


def _band_width(cfg: Config, U1: int) -> int:
    """The joint's window a frame: U+1 exact, or the banded loss's Wp at the
    band the step resolves for the loop's padded U (labels to ×16)."""
    from statecatcher_tpu_torch.ops.rnnt_band import band_width
    from statecatcher_tpu_torch.train.step import resolve_rnnt_band

    band = resolve_rnnt_band(cfg.train.rnnt_band, -(-(U1 - 1) // 16) * 16)
    return band_width(band, U1, cfg.train.rnnt_time_block) if band > 0 else U1


def train_step_roofline(
    cfg: Config,
    feat_dim: int = 80,
    max_label_len: int = 128,
    mode: str = "ctc",
    peak_flops: Optional[float] = None,
    peak_hbm: float = H100_PEAK_HBM_BPS,
) -> Roofline:
    m = cfg.model
    V = m.vocab_size
    stack = max(1, m.stack_order)
    # frames per audio-second at the (possibly stacked) encoder rate
    hop_s = cfg.frontend.hop_length / cfg.frontend.sample_rate
    frames = (1.0 / hop_s) / stack
    act_bytes = 2 if m.dtype == "bfloat16" else 4
    if peak_flops is not None:
        gemm_peak = kernel_peak = peak_flops
    elif m.dtype == "bfloat16":
        gemm_peak = kernel_peak = H100_PEAK_FLOPS_BF16
    else:
        gemm_peak, kernel_peak = H100_PEAK_FLOPS_F32, H100_PEAK_FLOPS_TF32 / 3
    seg_audio = cfg.data.batch_size * cfg.data.target_duration

    din0 = feat_dim * stack
    proj_frame = 0.0
    n_proj = 0
    if m.input_proj_dim > 0:
        # applied at the frame rate before stacking: ``stack`` input frames
        # an encoder frame
        proj_frame = 2 * feat_dim * m.input_proj_dim * stack
        n_proj = feat_dim * m.input_proj_dim
        din0 = m.input_proj_dim * stack
    gemm_frame, mixer_frame, n_params, gates, layers = _encoder(cfg, din0)
    gemm_frame += proj_frame
    n_params += n_proj

    # ---- product FLOPs per frame (forward) ----
    exp_frame = 0.0
    gemm_sec = 0.0                     # per-label products, a second
    if mode == "ctc":
        S = 2 * max_label_len + 1
        # the emission term of the convention (the port gathers it)
        emission = 2 * V * S
        flops_frame = 3 * (gemm_frame + mixer_frame + emission)
        joint_exec_frame = 0.0
    else:
        J, E_p = m.rnnt_joiner_dim, m.rnnt_pred_emb_dim
        U1 = max_label_len + 1
        # the joiner: enc_proj a frame, pred_proj a label position
        gemm_frame += 2 * V * J
        gemm_sec = 3 * 2 * E_p * J * U1 / max(cfg.data.target_duration, 1e-9)
        n_params += V * E_p + V * J + E_p * J + J * V
        flops_frame = 3 * (gemm_frame + mixer_frame + 2 * U1 * J * V)
        W = _band_width(cfg, U1)
        joint_exec_frame = 8 * W * J * V
        exp_frame = 2 * W * V

    # ---- principal HBM bytes per frame ----
    by = 0.0
    if m.encoder == "xlstm":
        E, H, nb, dqk, dv, Lc, dff = _xlstm_dims(m)
        # per block: q/k/v/ogate planes (w+r), ffn intermediates, mixer-local
        # (L, L) tensors saved for the chunk-scan backward (S/expD/W, f32, ÷Lc
        # per frame), h stacked f32, chunk state C (w+r ÷Lc); ×2 for the
        # mirrored backward traffic
        per_block = (
            2 * (2 * H * dqk + 2 * H * dv) * act_bytes     # q,k,v,o planes
            + 2 * (2 * dff + E) * act_bytes                # ffn gate/up/down
            + 3 * 2 * H * Lc * 4                           # S, expD, W rows
            + 2 * H * dv * 4                               # h (f32 scan out)
            + 2 * H * dqk * dv * 4 * 2 / Lc                # C carry w+r
        )
        by += 2 * nb * per_block
        by += 2 * 2 * nb * E * act_bytes                   # residual stream
    else:
        D = m.hidden_size
        # gate tensors: written by matmul, read by scan prep; grads mirrored
        by += 2 * (2 * gates * D * act_bytes)
        # two scans per layer: coefficients in + state out, f32, fwd + bwd adjoint
        by += 2 * (2 * (2 * D * 4) + 2 * (2 * D * 4))
        by *= layers
        # inter-layer activations (write + read, fwd + bwd)
        by += 2 * 2 * layers * D * act_bytes
    # logits + log_probs + dlogits, f32
    by += 3 * 2 * V * 4
    if mode == "ctc":
        # emit, alpha, beta, gamma tiles (f32, write+read each)
        by += 4 * 2 * (2 * max_label_len + 1) * 4
    else:
        # blank/emit tables + lattice alpha/occupancy (f32, write+read each)
        by += 5 * 2 * (max_label_len + 1) * 4

    # optimizer: adam reads p,g,m,v and writes p,m,v in f32 once per
    # segment update; amortized over the audio-seconds of one segment batch
    opt_bytes_per_audio_sec = n_params * 4 * 7 / max(seg_audio, 1e-9)

    flops_per_audio_sec = flops_frame * frames + gemm_sec
    bytes_per_audio_sec = by * frames + opt_bytes_per_audio_sec

    t_flops = ((3 * gemm_frame * frames + gemm_sec) / gemm_peak
               + (3 * mixer_frame + joint_exec_frame) * frames / kernel_peak)
    t_bytes = bytes_per_audio_sec / peak_hbm
    t_exp = exp_frame * frames / H100_EXP_PER_S
    sol = 1.0 / max(t_flops, t_bytes, t_exp)
    return Roofline(flops_per_audio_sec, bytes_per_audio_sec, sol)
