"""How far the RWKV WKV's f32 forms are from a float64 step loop, on the CPU.

    PYTHONPATH=. python tools/wkv_orders.py [--B 2] [--T 1598] [--D 64] [--chunks 16 64]

Draws k, v ~ N(0, 1), the init's decays w = exp(linspace(−5, 1, D)) and a
bonus u ~ 0.5·N(0, 1) from seed 0, runs the recurrence step by step in
float64, and prints for each f32 form its largest and root-mean-square
error against it:

  * ``jax``: the JAX package's ``wkv_parallel`` (three ``lax.associative_scan``s);
  * ``hillis-steele``: the port's ``models/rwkv.py`` (⌈log₂ T⌉ doubling steps);
  * ``chunked C``: ``torch.logcumsumexp`` of logb_s + w·(s − s₀) within chunks
    of C frames, minus w·(t − s₀), the chunk's carry decayed in by a short
    loop over chunks (the form the port does not use).

``tests/test_torch_rwkv.py`` holds the port within 2× of JAX's error at
these sizes.  Needs the JAX package (CPU).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

NEG = -1e30


def step_loop(k, v, w, u):
    out = np.zeros_like(k)
    num = np.zeros(k.shape[::2])
    den = np.zeros(k.shape[::2])
    for t in range(k.shape[1]):
        ek_u = np.exp(u + k[:, t])
        out[:, t] = (num + ek_u * v[:, t]) / (den + ek_u)
        num = np.exp(-w) * num + np.exp(k[:, t]) * v[:, t]
        den = np.exp(-w) * den + np.exp(k[:, t])
    return out


def chunked_scan(C: int):
    """A ``decay_logsum_scan`` in chunks of C frames (empty initial state)."""
    def scan(logb, w, init):
        outs, carry = [], init
        for s0 in range(0, logb.shape[-2], C):
            c = min(C, logb.shape[-2] - s0)
            r = torch.arange(c, dtype=logb.dtype)[:, None] * w
            local = torch.logcumsumexp(logb[..., s0:s0 + c, :] + r, dim=-2) - r
            full = torch.logaddexp(local, carry[..., None, :] - (r + w))
            outs.append(full)
            carry = full[..., -1, :]
        return torch.cat(outs, dim=-2)
    return scan


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--B", type=int, default=2)
    ap.add_argument("--T", type=int, default=1598)
    ap.add_argument("--D", type=int, default=64)
    ap.add_argument("--chunks", type=int, nargs="*", default=[16, 64])
    args = ap.parse_args(argv)

    import jax.numpy as jnp
    from statecatcher_tpu.models.rwkv import wkv_parallel as j_wkv
    from statecatcher_tpu_torch.models import rwkv

    rng = np.random.default_rng(0)
    k, v = rng.standard_normal((2, args.B, args.T, args.D))
    w = np.exp(np.linspace(-5.0, 1.0, args.D))
    u = 0.5 * rng.standard_normal(args.D)
    want = step_loop(k, v, w, u)
    f32 = [np.asarray(a, np.float32) for a in (k, v, w, u)]
    empty = np.full((args.B, args.D), NEG, np.float32)

    forms = {"jax": lambda: np.asarray(j_wkv(*map(jnp.asarray, f32), (jnp.asarray(empty),) * 3)[0])}

    def port(scan=None):
        saved = rwkv.decay_logsum_scan
        if scan is not None:
            rwkv.decay_logsum_scan = scan
        try:
            with torch.inference_mode():
                out, _ = rwkv.wkv_parallel(*map(torch.from_numpy, f32),
                                           (torch.from_numpy(empty),) * 3)
            return out.numpy()
        finally:
            rwkv.decay_logsum_scan = saved

    forms["hillis-steele"] = port
    for C in args.chunks:
        forms[f"chunked {C}"] = lambda C=C: port(chunked_scan(C))
    base = None
    for name, run in forms.items():
        err = np.abs(run().astype(np.float64) - want)
        mx, rms = err.max(), np.sqrt((err ** 2).mean())
        base = base or (mx, rms)
        print(f"{name:>14}: max |error| {mx:.3e} ({mx / base[0]:.2f}× JAX's), rms {rms:.3e} "
              f"({rms / base[1]:.2f}×)  [B={args.B}, T={args.T}, D={args.D}, f32 vs float64]")


if __name__ == "__main__":
    main()
