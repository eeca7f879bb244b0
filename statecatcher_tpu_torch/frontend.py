"""Feature frontend in PyTorch: STFT → mel filterbank → log-mel / MFCC.

Port of ``statecatcher_tpu/frontend.py``, same numerics contract (reference
torchaudio semantics): periodic Hann window, ``center=False``, power-2
spectrogram, HTK mel scale with ``norm=None`` triangles, ``AmplitudeToDB
(top_db=80)`` for kind="mel", natural-log mels + DCT-II (ortho) for
kind="mfcc".

The windowed DFT, the mel projection and the DCT are plain matmuls.  The JAX
package runs them at ``Precision.HIGHEST``; here they must run in full
float32, so on the card ``compute_features`` refuses to run while TF32
matmuls are enabled (``torch.backends.cuda.matmul.allow_tf32``, which
``torch.set_float32_matmul_precision("high")`` also turns on), because
TF32 keeps about three decimal digits.  The bases are built once per config
and device and kept on the device (``_bases``).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from statecatcher_tpu_torch.config import FrontendConfig


# --------------------------------------------------------------------------- #
# Filterbank / window construction (host-side numpy, copied from the JAX
# package so both build bit-identical bases)
# --------------------------------------------------------------------------- #
def hann_window_periodic(win_length: int) -> np.ndarray:
    """Periodic Hann window (torch.hann_window default)."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * n / win_length))).astype(np.float32)


def _hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


def mel_filterbank(
    n_freqs: int,
    n_mels: int,
    sample_rate: int,
    f_min: float = 0.0,
    f_max: float | None = None,
    mel_scale: str = "htk",
) -> np.ndarray:
    """Triangular mel filterbank, shape (n_freqs, n_mels), norm=None
    (torchaudio ``melscale_fbanks``)."""
    if f_max is None:
        f_max = sample_rate / 2.0
    if mel_scale != "htk":
        raise NotImplementedError("only htk mel scale (reference parity) is supported")
    all_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    m_min = _hz_to_mel_htk(f_min)
    m_max = _hz_to_mel_htk(f_max)
    m_pts = np.linspace(m_min, m_max, n_mels + 2)
    f_pts = _mel_to_hz_htk(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]                     # (n_mels+1,)
    slopes = f_pts[None, :] - all_freqs[:, None]        # (n_freqs, n_mels+2)
    down_slopes = -slopes[:, :-2] / f_diff[:-1]
    up_slopes = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down_slopes, up_slopes))
    return fb.astype(np.float32)


def dct_matrix(n_mfcc: int, n_mels: int, norm: str = "ortho") -> np.ndarray:
    """DCT-II basis, shape (n_mels, n_mfcc) — torchaudio ``create_dct``."""
    n = np.arange(n_mels, dtype=np.float64)
    k = np.arange(n_mfcc, dtype=np.float64)[:, None]
    dct = np.cos(np.pi / n_mels * (n + 0.5) * k)        # (n_mfcc, n_mels)
    if norm is None:
        dct *= 2.0
    else:
        assert norm == "ortho"
        dct[0] *= 1.0 / math.sqrt(2.0)
        dct *= math.sqrt(2.0 / n_mels)
    return dct.T.astype(np.float32)                     # (n_mels, n_mfcc)


def num_frames(num_samples: int, cfg: FrontendConfig) -> int:
    """Frame count for center=False framing: 1 + (S − n_fft) // hop."""
    assert not cfg.center
    return 1 + (num_samples - cfg.n_fft) // cfg.hop_length


def windowed_dft_matrix(n_fft: int, win_length: int) -> np.ndarray:
    """Real-DFT basis with the analysis window folded in, (n_fft, 2·n_freqs):
    columns [cos_0..cos_F | −sin_0..−sin_F], so ``frames @ W`` is re‖im of
    ``rfft(frames · window)``.  The window is zero-padded centered to n_fft
    when win_length < n_fft (torch.stft semantics)."""
    n_freqs = n_fft // 2 + 1
    n = np.arange(n_fft, dtype=np.float64)
    k = np.arange(n_freqs, dtype=np.float64)
    ang = 2.0 * np.pi * np.outer(n, k) / n_fft
    w = np.zeros(n_fft, dtype=np.float64)
    left = (n_fft - win_length) // 2
    w[left:left + win_length] = hann_window_periodic(win_length).astype(np.float64)
    basis = np.concatenate([np.cos(ang), -np.sin(ang)], axis=1)
    return (w[:, None] * basis).astype(np.float32)


# --------------------------------------------------------------------------- #
# Tensor frontend
# --------------------------------------------------------------------------- #
def _check_full_f32(x: torch.Tensor) -> None:
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "the frontend's DFT/mel/DCT matmuls must run in full float32 "
            "(the JAX package uses Precision.HIGHEST), but TF32 matmuls are "
            "enabled; call torch.set_float32_matmul_precision('highest')"
        )


@functools.lru_cache(maxsize=8)
def _bases(cfg: FrontendConfig, device: torch.device):
    """(windowed DFT, mel filterbank, DCT) float32 tensors on ``device``."""
    n_freqs = cfg.n_fft // 2 + 1
    mats = (windowed_dft_matrix(cfg.n_fft, cfg.win_length),
            mel_filterbank(n_freqs, cfg.n_mels, cfg.sample_rate, mel_scale=cfg.mel_scale),
            dct_matrix(cfg.n_mfcc, cfg.n_mels, "ortho"))
    return tuple(torch.from_numpy(m).to(device) for m in mats)


def power_spectrogram(x: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """(B, S) float32 → (B, T, n_freqs) power spectrogram: windowing + real
    DFT as f32 matmuls over the strided (B, T, n_fft) frame view.

    The contraction over n_fft is split at multiples of hop, as the JAX
    package splits it, and the partial products are summed: shorter f32
    dot products, which on a CPU test input took the MFCCs' largest error
    against a float64 evaluation from 2.1e-5 (one K=400 matmul) to 9.1e-6.
    """
    x = x.to(torch.float32)
    _check_full_f32(x)
    W = _bases(cfg, x.device)[0]
    hop, n_fft = cfg.hop_length, cfg.n_fft
    T = num_frames(x.shape[1], cfg)
    frames = x.unfold(1, n_fft, hop)[:, :T]                    # (B, T, n_fft)
    spec = None
    for j in range(0, n_fft, hop):
        part = torch.matmul(frames[..., j:j + hop], W[j:j + hop])
        spec = part if spec is None else spec + part           # (B, T, 2·n_freqs)
    F = cfg.n_fft // 2 + 1
    p = spec[..., :F].square() + spec[..., F:].square()
    if cfg.power != 2.0:
        p = p ** (cfg.power / 2.0)
    return p


def amplitude_to_db(x: torch.Tensor, top_db: float = 80.0,
                    amin: float = 1e-10) -> torch.Tensor:
    """Power → dB with per-utterance top_db clamp (torchaudio AmplitudeToDB):
    the floor is ``max_db − top_db`` over each batch element's (time, freq)."""
    x_db = 10.0 * torch.log10(torch.clamp(x, min=amin))
    max_db = x_db.amax(dim=tuple(range(1, x_db.ndim)), keepdim=True)
    return torch.maximum(x_db, max_db - top_db)


def compute_features(x: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """(B, S) waveform → (B, T, n_feats) float32 features, time-major.

    kind="mel":  log-mel (dB, top_db-clamped).
    kind="mfcc": natural-log mels → DCT-II ortho.
    """
    p = power_spectrogram(x, cfg)                              # (B, T, n_freqs)
    _, fb, dct = _bases(cfg, p.device)
    mel = torch.matmul(p, fb)
    if cfg.kind == "mel":
        return amplitude_to_db(mel, top_db=cfg.top_db)
    if cfg.kind == "mfcc":
        if cfg.log_mels:
            logmel = torch.log(mel + 1e-6)
        else:
            logmel = amplitude_to_db(mel, top_db=cfg.top_db)
        return torch.matmul(logmel, dct)
    raise ValueError(f"Unsupported frontend: {cfg.kind}")


def feat_dim(cfg: FrontendConfig) -> int:
    """Feature dimension — computed exactly, not probed."""
    return cfg.n_mfcc if cfg.kind == "mfcc" else cfg.n_mels


# --------------------------------------------------------------------------- #
# Sample-mask → frame-mask / lengths
# --------------------------------------------------------------------------- #
def compute_frame_mask(sample_mask: torch.Tensor, num_feat_frames: int,
                       stack_order: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """Boolean (B, S) sample mask → ((B, T) frame mask, (B,) int32 frame
    lengths).  Any-pooling of the sample mask over each ``S/T × stack_order``
    window; ``in_lens = sum(mask)/subsample`` (float32, truncated) clamped
    to T — the JAX package's arithmetic, so lengths match exactly."""
    B, S = sample_mask.shape
    T = num_feat_frames // stack_order if stack_order > 1 else num_feat_frames
    subsample = (S / num_feat_frames) * float(stack_order)
    win = int(subsample)
    reshaped = sample_mask[:, :T * win].reshape(B, T, win)
    frame_mask = reshaped.any(dim=2)
    total = sample_mask.sum(dim=1, dtype=torch.int32).to(torch.float32)
    in_lens = torch.clamp((total / subsample).to(torch.int32), max=T)
    return frame_mask, in_lens


def frame_mask_from_lens(sample_lens: torch.Tensor, num_samples: int,
                         num_feat_frames: int, stack_order: int = 1
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Prefix-length (B,) int32 → ((B, T) frame mask, (B,) frame lengths):
    ``compute_frame_mask``'s exact result for prefix sample masks."""
    T = num_feat_frames // stack_order if stack_order > 1 else num_feat_frames
    subsample = (num_samples / num_feat_frames) * float(stack_order)
    win = int(subsample)
    t = torch.arange(T, dtype=torch.int32, device=sample_lens.device)
    frame_mask = t[None, :] * win < sample_lens[:, None]
    in_lens = torch.clamp(
        (sample_lens.to(torch.float32) / subsample).to(torch.int32), max=T)
    return frame_mask, in_lens
