"""Seeded inputs for checking the port: synthetic audio and random weights.

``randomize_`` gives a model random weights that keep f32 round-off small;
running this module measures why that matters, on the card by default (it
raises without one; ``--device cpu`` runs the plain PyTorch versions):

    python -m statecatcher_tpu_torch.testing [--seconds 10] [--device cuda|cpu]
        [--variant triton|native]

It builds the flagship LucyRNN-CTC (4 × 512, vocab 1024, 80 MFCC; the 7-gate
cell, or with ``--variant native`` the 6-gate one), gives it random weights
(for the 7-gate cell with and without the gate-bias offsets; the native
cell has no gate_proj), runs the same features through it in float32 and in
float64, and prints how often the greedy frames differ and the edit
distance of the greedy tokens.
"""

from __future__ import annotations

import argparse
import copy

import numpy as np
import torch


def synth_audio(rng: np.random.Generator, B: int, S: int) -> np.ndarray:
    """Gliding tones in noise, (B, S) float32 in [-1, 1]."""
    t = np.arange(S, dtype=np.float64) / 16000.0
    f0 = rng.uniform(100.0, 400.0, (B, 1))
    glide = rng.uniform(50.0, 300.0, (B, 1))
    tone = 0.3 * np.sin(2 * np.pi * (f0 + glide * np.sin(0.7 * t)) * t)
    return (tone + rng.uniform(-0.2, 0.2, (B, S))).astype(np.float32)


def randomize_(model: torch.nn.Module, seed: int, offset_gate_biases: bool = True,
               gate_weight_scale: float = 1.0) -> None:
    """Seeded random weights everywhere: the output projection (LucyRNN's
    ``output_proj``, the xLSTM's and RWKV's ``vocab_proj``) is zero at init,
    and greedy decoding of zero logits emits nothing.  Any encoder takes them; the gate
    options below name LucyRNN's ``gate_proj`` and leave others alone.

    Matrices are N(0, 0.25/fan_in); other vectors get 0.1·N(0, 1) added.
    With ``offset_gate_biases`` the gate biases of k and v get ±2 and of
    h_pre ±1 (random signs).  With the init's zero biases, random weights
    put many (k, v) near the origin, where kv = k·v/(q(q+ε)) blows up, and
    many h_pre near 0, where h_pre/√(h_pre²+ε) has gain ε^-½ = 1e3; f32
    round-off then changes the greedy output of a whole frame often enough
    that no comparison of two f32 runs can tell a fault from round-off
    (``python -m statecatcher_tpu_torch.testing`` measures it).

    ``gate_weight_scale`` scales every gate projection matrix.  Training
    checks use 0.1: the gradient near those singular points is still
    amplified (q⁻³ for kv), and at scale 1 the features spread the gate
    inputs over them (a grad norm moved by 13 % between two f32 orders of
    the same sums); at 0.1 every gate input stays near its offset bias.
    """
    gen = torch.Generator().manual_seed(seed)

    def signs(n):
        return torch.where(torch.rand(n, generator=gen) < 0.5, -1.0, 1.0)

    with torch.no_grad():
        for name, p in model.named_parameters():
            noise = torch.randn(p.shape, generator=gen)
            if p.ndim == 2:                                   # (out, in)
                value = noise * (0.5 / p.shape[1] ** 0.5)
            else:
                value = p.detach().cpu().double() + 0.1 * noise
            if name.endswith("gate_proj.weight"):
                value = value * gate_weight_scale
            if offset_gate_biases and name.endswith("gate_proj.bias"):
                D = p.shape[0] // 7
                value[2 * D:4 * D] += 2.0 * signs(2 * D)      # k, v
                value[4 * D:5 * D] += 1.0 * signs(D)          # h_pre
            p.copy_(value.to(p.device, p.dtype))


def levenshtein(a: list[int], b: list[int]) -> int:
    """Edit distance between two token lists."""
    prev = list(range(len(b) + 1))
    for i, x in enumerate(a, 1):
        cur = [i]
        for j, y in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (x != y)))
        prev = cur
    return prev[-1]


def _as_float64(model: torch.nn.Module) -> torch.nn.Module:
    """A float64 copy of a model whose modules compute in ``.dtype``."""
    m64 = copy.deepcopy(model).double()
    for mod in m64.modules():
        if isinstance(getattr(mod, "dtype", None), torch.dtype):
            mod.dtype = torch.float64
    return m64


def roundoff_report(seconds: float, device: str, seed: int = 0, variant: str = "triton") -> None:
    from statecatcher_tpu_torch import resolve_device
    from statecatcher_tpu_torch.config import Config
    from statecatcher_tpu_torch.decode import ctc_greedy_decode_to_lists
    from statecatcher_tpu_torch.frontend import compute_features
    from statecatcher_tpu_torch.models.speech import build_speech_model

    device = resolve_device(device)
    cfg = Config().apply_overrides(["--model.encoder", "lucyrnn",
                                    "--model.lucyrnn.variant", variant])
    audio = synth_audio(np.random.default_rng(seed + 2), 2, int(seconds * 16000))
    for offset in ((False, True) if variant == "triton" else (True,)):
        model = build_speech_model(cfg.model, cfg.frontend.n_mfcc, "ctc", device=device,
                                   generator=torch.Generator().manual_seed(seed))
        randomize_(model, seed + 1, offset_gate_biases=offset)
        with torch.inference_mode():
            feats = compute_features(torch.from_numpy(audio).to(device), cfg.frontend)
            lp32 = torch.log_softmax(model(feats)[0], -1).double()
            lp64 = torch.log_softmax(_as_float64(model)(feats.double())[0], -1)
        lens = torch.full((2,), lp32.shape[1])
        tok32 = ctc_greedy_decode_to_lists(lp32, lens)
        tok64 = ctc_greedy_decode_to_lists(lp64, lens)
        d = (lp32 - lp64).abs()
        what = f"gate-bias offsets {'on ' if offset else 'off'}" if variant == "triton" else variant
        print(f"{what}: float32 vs float64 over "
              f"2 × {seconds} s: greedy frames equal "
              f"{(lp32.argmax(-1) == lp64.argmax(-1)).double().mean().item():.4%}; "
              f"max|Δ log-probs| {d.max().item():.3e} (median {d.median().item():.3e}, "
              f"scale {lp64.abs().max().item():.3e}); tokens "
              f"{[len(t) for t in tok64]}, edit distance "
              f"{[levenshtein(a, b) for a, b in zip(tok32, tok64)]}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--variant", choices=("triton", "native"), default="triton")
    args = ap.parse_args(argv)
    roundoff_report(args.seconds, args.device, variant=args.variant)


if __name__ == "__main__":
    main()
