"""How far K7's f32 orders of work are from float64: the anti-diagonal walk
of the wavefront route (with its shift, and without it) and the frame scan
of the scan route (and of the TPU kernel), each as the plain versions of
``ops/rnnt_lattice.py`` compute it (``order="diagonals"`` / ``"frames"``;
on the card the wavefront gives the shifted diagonal walk's bits).

For each lattice it prints, for each order in float32 against the same
lattice in float64: the NLL's largest error, α's and β's largest error on
live values (also as a share of the card tests' tolerance, 2e-5 + 2e-6 of
the value), the occupancy gradient's distance (``occupancy_grads``, as a
share of the float64 gradient's norm) and the error of each row's summed
blank occupancies (mean and largest; a row's occupancies all move by one
factor when its α and β round apart, which scales its gradient).

    python tools/rnnt_lattice_orders.py --B 4 --T 1598 --U 48 --scale 6.93
    python tools/rnnt_lattice_orders.py --B 2 --T 20 --U 1500
    python tools/rnnt_lattice_orders.py --capture tables.pt   # on a card
    python tools/rnnt_lattice_orders.py --tables tables.pt

``--scale`` s > 0 draws log-probs near −s (−s + ``--noise``·N(0, 1): a
random model's joint, s = log V); by default N(0, 1) − 1.5 (the card
tests' ``lattice_data``).  ``--capture`` runs ``chip_smoke.py`` phase 9's
group (B=32, T=1598, U=48, two segments) on the plain path on the card and
saves each segment's blank, emit and lengths; ``--tables`` reads them (its
last row, invalid in phase 9, gets no cotangent).  Runs on the CPU unless
``--device`` names a card.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from mlstm_bwd_ab import load_chip_smoke  # noqa: E402

from statecatcher_tpu_torch.ops import rnnt_lattice  # noqa: E402
from statecatcher_tpu_torch.ops.rnnt_lattice import (  # noqa: E402
    nll_from_alpha,
    occupancy_grads,
    rnnt_alpha_ref,
    rnnt_beta_ref,
)


def lattice(B: int, T: int, U: int, scale: float, noise: float, seed: int) -> dict:
    """float64 blank (B, T, U+1), emit (B, T, U), full lengths."""
    rng = np.random.default_rng(seed)
    draw = ((lambda *s: -scale + noise * rng.standard_normal(s)) if scale > 0
            else (lambda *s: rng.standard_normal(s) - 1.5))
    return {"blank": torch.from_numpy(draw(B, T, U + 1)), "emit": torch.from_numpy(draw(B, T, U)),
            "t_lens": torch.full((B,), T, dtype=torch.int32),
            "u_lens": torch.full((B,), U, dtype=torch.int32)}


@contextlib.contextmanager
def unshifted(on: bool):
    """The diagonal walk without its shift while the block runs."""
    saved = rnnt_lattice._SHIFT_FROM
    if on:
        rnnt_lattice._SHIFT_FROM = float("inf")
    try:
        yield
    finally:
        rnnt_lattice._SHIFT_FROM = saved


def solve(lat: dict, dtype, order: str, weight):
    blank, emit = lat["blank"].to(dtype), lat["emit"].to(dtype)
    t_lens, u_lens = lat["t_lens"], lat["u_lens"]
    alpha = rnnt_alpha_ref(blank, emit, t_lens, order=order)
    beta = rnnt_beta_ref(blank, emit, t_lens, u_lens, order=order)
    nll = nll_from_alpha(alpha, blank, t_lens, u_lens)
    g_blank, g_emit = occupancy_grads(blank, emit, t_lens, u_lens, alpha, beta, nll,
                                      weight.to(dtype))
    return alpha, beta, nll, g_blank, g_emit


def report(lat: dict, dev) -> None:
    lat = {k: v.to(dev) if torch.is_tensor(v) else v for k, v in lat.items()}
    B = lat["blank"].shape[0]
    weight = torch.ones(B, device=dev)
    if lat.get("last_row_invalid"):
        weight[-1] = 0
    live_rows = weight > 0
    a64, b64, n64, gb64, ge64 = solve(lat, torch.float64, "diagonals", weight)
    g64 = torch.cat([gb64.flatten(), ge64.flatten()])
    occ64 = gb64.sum((1, 2))
    for name, order, off in (("diagonals", "diagonals", False),
                             ("diagonals unshifted", "diagonals", True),
                             ("frames", "frames", False)):
        with unshifted(off):
            a, b, n, gb, ge = solve(lat, torch.float32, order, weight)
        errs = []
        for got, want in ((a, a64), (b, b64)):
            live = want > -1e29
            d = (got.double() - want)[live].abs()
            errs.append((d.max().item(), (d / (2e-5 + 2e-6 * want[live].abs())).max().item()))
        g = torch.cat([gb.flatten(), ge.flatten()]).double()
        occ = (gb.double().sum((1, 2)) / occ64 - 1)[live_rows]
        print(f"  {name} (f32): NLL max|Δ| {(n.double() - n64).abs().max().item():.3e}; "
              f"α max|Δ| {errs[0][0]:.3e} ({errs[0][1]:.2f} of the tolerance), β max|Δ| "
              f"{errs[1][0]:.3e} ({errs[1][1]:.2f}); occupancy gradient "
              f"{((g - g64).norm() / g64.norm()).item():.3e} of its norm; rows' blank "
              f"occupancy sums off by {occ.mean().item():.3e} on average, "
              f"{occ.abs().max().item():.3e} at most", flush=True)


def capture(path: str) -> None:
    """Phase 9's group on the plain path on the card: each segment's K7
    inputs, saved to ``path``."""
    cs = load_chip_smoke()
    from statecatcher_tpu_torch.config import Config

    dev = torch.device("cuda", 0)
    cfg = Config().apply_overrides(cs.FLAGSHIP)
    cfg, state, step, group = cs.train_setup(cfg, dev, 2, 32, 16 * 16000, 48, "rnnt")
    saved = []
    with cs.plain_kernels():
        beta = rnnt_lattice.rnnt_beta

        def keep(blank, emit, t_lens, u_lens):
            saved.append({"blank": blank.detach().cpu(), "emit": emit.detach().cpu(),
                          "t_lens": t_lens.cpu(), "u_lens": u_lens.cpu(),
                          "last_row_invalid": True})
            return beta(blank, emit, t_lens, u_lens)

        rnnt_lattice.rnnt_beta = keep
        step(state, cs.init_carry(cfg.model, 32, device=dev), *group, np.ones(2, bool))
    torch.save(saved, path)
    print(f"saved {len(saved)} segments' tables to {path}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--B", type=int, default=4)
    ap.add_argument("--T", type=int, default=1598)
    ap.add_argument("--U", type=int, default=48)
    ap.add_argument("--scale", type=float, default=0.0)
    ap.add_argument("--noise", type=float, default=0.3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--capture", default=None, help="save phase 9's tables here (a card)")
    ap.add_argument("--tables", default=None, help="saved tables to report on")
    args = ap.parse_args()
    if args.capture:
        capture(args.capture)
        return 0
    dev = torch.device(args.device)
    if args.tables:
        for k, lat in enumerate(torch.load(args.tables)):
            print(f"segment {k}: B, T, U+1 = {tuple(lat['blank'].shape)}", flush=True)
            report(lat, dev)
        return 0
    print(f"B={args.B}, T={args.T}, U={args.U}, scale {args.scale}, noise {args.noise}, "
          f"seed {args.seed}", flush=True)
    report(lattice(args.B, args.T, args.U, args.scale, args.noise, args.seed), dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
