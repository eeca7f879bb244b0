"""PyTorch port frontend (statecatcher_tpu_torch/frontend.py) against the JAX
frontend on the same synthetic audio.

Features: both sides are f32 matmuls that sum in different orders (both
split each frame's DFT into hop-aligned partial products, but each library
sums inside a product its own way).  MFCCs (magnitude up to ~20) are held
at atol 1e-4; this input measured max |Δ| ≈ 1e-5.  Log-mel dB values carry
the f32 relative error of their power ×4.34 (10·log10), so a bin 80 dB
below the frame peak is off the f64 truth by ~1e-4 on EACH side (measured here: port 1.35e-4, JAX 1.07e-4);
they are held at atol 1e-4 plus rtol 1e-5 of the dB value.  A second test
holds the port alone against a float64 numpy evaluation of the same math:
within 5e-5 on MFCCs and 5e-4 dB on log-mels (measured on this input:
2.1e-5 and 2.1e-4; JAX: 5.3e-6 and 4.5e-5).  Masks and lengths are integer
results and must match exactly.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from statecatcher_tpu import frontend as jfe
from statecatcher_tpu.config import FrontendConfig as JFrontendConfig
from statecatcher_tpu_torch import frontend as tfe
from statecatcher_tpu_torch.config import FrontendConfig


def _audio(seed, B=2, S=16000 + 333):
    rng = np.random.default_rng(seed)
    t = np.arange(S) / 16000.0
    tone = 0.3 * np.sin(2 * np.pi * (200 + 300 * t) * t)
    return (tone[None] + rng.uniform(-0.2, 0.2, (B, S))).astype(np.float32)


@pytest.mark.parametrize("kind", ["mfcc", "mel"])
def test_compute_features_matches_jax(kind):
    cfg = FrontendConfig(kind=kind)
    jcfg = JFrontendConfig(**dataclasses.asdict(cfg))
    x = _audio(0)
    want = np.asarray(jfe.compute_features(jnp.asarray(x), jcfg))
    got = tfe.compute_features(torch.from_numpy(x), cfg).numpy()
    assert got.shape == want.shape == (2, tfe.num_frames(x.shape[1], cfg), tfe.feat_dim(cfg))
    np.testing.assert_allclose(got, want, rtol=0 if kind == "mfcc" else 1e-5, atol=1e-4)


def _features_f64(x, cfg):
    """The frontend's math in float64 numpy, on the same f32 bases."""
    W = tfe.windowed_dft_matrix(cfg.n_fft, cfg.win_length).astype(np.float64)
    T = tfe.num_frames(x.shape[1], cfg)
    idx = np.arange(T)[:, None] * cfg.hop_length + np.arange(cfg.n_fft)[None]
    spec = x.astype(np.float64)[:, idx] @ W
    F = cfg.n_fft // 2 + 1
    mel = (spec[..., :F] ** 2 + spec[..., F:] ** 2) @ tfe.mel_filterbank(
        F, cfg.n_mels, cfg.sample_rate).astype(np.float64)
    if cfg.kind == "mel":
        db = 10.0 * np.log10(np.maximum(mel, 1e-10))
        return np.maximum(db, db.max(axis=(1, 2), keepdims=True) - cfg.top_db)
    return np.log(mel + 1e-6) @ tfe.dct_matrix(cfg.n_mfcc, cfg.n_mels).astype(np.float64)


@pytest.mark.parametrize("kind", ["mfcc", "mel"])
def test_features_match_f64(kind):
    cfg = FrontendConfig(kind=kind)
    x = _audio(1)
    got = tfe.compute_features(torch.from_numpy(x), cfg).numpy()
    np.testing.assert_allclose(got, _features_f64(x, cfg), rtol=0,
                               atol=5e-5 if kind == "mfcc" else 5e-4)


def test_bases_are_copies():
    np.testing.assert_array_equal(tfe.windowed_dft_matrix(400, 400),
                                  jfe.windowed_dft_matrix(400, 400))
    np.testing.assert_array_equal(tfe.mel_filterbank(201, 80, 16000),
                                  jfe.mel_filterbank(201, 80, 16000))
    np.testing.assert_array_equal(tfe.dct_matrix(40, 80), jfe.dct_matrix(40, 80))


@pytest.mark.parametrize("stack_order", [1, 2, 3])
def test_frame_masks_match_jax_exactly(stack_order):
    cfg = FrontendConfig()
    rng = np.random.default_rng(stack_order)
    S = 16000 + 777
    T = tfe.num_frames(S, cfg)
    assert T == jfe.num_frames(S, JFrontendConfig())
    lens = np.array([S, 9001, 1, 0, 4321], np.int32)
    mask = np.arange(S)[None, :] < lens[:, None]
    mask[4, 12000:12050] = True                     # a non-prefix mask too
    mask &= rng.random(mask.shape) > 0.001
    jm, jl = jfe.compute_frame_mask(jnp.asarray(mask), T, stack_order)
    tm, tl = tfe.compute_frame_mask(torch.from_numpy(mask), T, stack_order)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert tl.dtype == torch.int32

    jm, jl = jfe.frame_mask_from_lens(jnp.asarray(lens), S, T, stack_order)
    tm, tl = tfe.frame_mask_from_lens(torch.from_numpy(lens), S, T, stack_order)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


def test_amplitude_to_db_matches_jax():
    x = np.abs(np.random.default_rng(3).standard_normal((2, 7, 5))).astype(np.float32) ** 4
    x[0, 0, 0] = 0.0
    want = np.asarray(jfe.amplitude_to_db(jnp.asarray(x)))
    got = tfe.amplitude_to_db(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
