"""Where the xLSTM training check's kernel-vs-plain update difference comes
from.  It runs ``chip_smoke.py``'s xLSTM CTC training group (phase 20: the
config's xLSTM, B=32, K=2 carried 16 s segments, U=128, lr 1e-6, gate
projections scaled by 0.1) once on the plain path (every kernel routed to its
plain version, as ``chip_smoke.plain_kernels`` does) and once per variant,
and holds each variant's parameters after the K updates against the plain
path's with phase 20's measures (updates' difference over their norm, share
of elements beyond 0.1·lr·K, loss and grad-norm differences):

    plain       the plain path again (the run-to-run floor; 0 if deterministic)
    k9a         K9a's kernel, everything else plain
    k9b         K9b's kernel, everything else plain
    k9          K9a and K9b's kernels, everything else plain
    all         every kernel (phase 20's kernel path)
    k3k4        the CTC lattice's kernels (K3, K4) only
    f64         the plain path with K9's plain versions in float64 (inputs
                cast up, outputs cast back): the check's sensitivity to the
                mLSTM's f32 round-off alone

    PYTHONPATH=. python tools/xlstm_update_diff.py [--variants k9a k9b ...] [--nofma]

``--nofma`` builds the kernels with ``nvcc --fmad=false`` (no contraction of
a multiply and an add into one FMA).  It prints the card's name and power
limit and one line per variant; it needs a CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess

import numpy as np
import torch

VARIANTS = ("plain", "k9a", "k9b", "k9", "all", "k3k4", "f64")


def _f64(fn):
    """``fn`` (a K9 plain version) on float64 copies of its float inputs,
    its outputs cast back to the dtypes the kernel would return."""

    def run(*args):
        xs = [a.double() if torch.is_tensor(a) and a.is_floating_point() else a for a in args]
        outs = fn(*xs)
        dts = [args[0].dtype, args[1].dtype, args[2].dtype] + [torch.float32] * 5
        return tuple(o.to(dt) for o, dt in zip(outs, dts))

    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS), choices=VARIANTS)
    ap.add_argument("--nofma", action="store_true", help="build with nvcc --fmad=false")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("xlstm_update_diff needs a CUDA card")
    import chip_smoke as cs
    from statecatcher_tpu_torch.config import Config
    from statecatcher_tpu_torch.models.asr import init_carry
    from statecatcher_tpu_torch.ops import _kernels, ctc_lattice, mlstm_fused

    if args.nofma:
        _kernels.NVCC_FLAGS = _kernels.NVCC_FLAGS + ("--fmad=false",)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"{smi}; nvcc flags {' '.join(_kernels.NVCC_FLAGS)}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _kernels.build_all()
    dev = torch.device("cuda", 0)

    # (module, attribute) → kernel wrapper, for putting a kernel back under
    # chip_smoke.plain_kernels()
    kernel = {(m, n): getattr(m, n) for m, n, _ in cs.PLAIN}
    keep = {"plain": [], "k9a": [(mlstm_fused, "mlstm_fused_fwd")],
            "k9b": [(mlstm_fused, "mlstm_fused_bwd")],
            "k9": [(mlstm_fused, "mlstm_fused_fwd"), (mlstm_fused, "mlstm_fused_bwd")],
            "all": list(kernel), "k3k4": [(ctc_lattice, "ctc_alpha"), (ctc_lattice, "ctc_beta")],
            "f64": []}

    @contextlib.contextmanager
    def routed(variant):
        with cs.plain_kernels():
            for m, n in keep[variant]:
                setattr(m, n, kernel[(m, n)])
            if variant == "f64":
                mlstm_fused.mlstm_fused_fwd = _f64(mlstm_fused.mlstm_fused_fwd_ref)
                mlstm_fused.mlstm_fused_bwd = _f64(mlstm_fused.mlstm_fused_bwd_ref)
            yield

    K, B = 2, 32
    cfg, state, step, group = cs.train_setup(Config().apply_overrides(cs.XLSTM), dev, K, B)
    p0, opt0 = cs.snapshot(state), state.state_dict()

    def run(variant):
        state.load_state_dict(opt0)
        with routed(variant):
            _, _, outs = step(state, init_carry(cfg.model, B, device=dev), *group,
                              np.ones(K, bool))
            torch.cuda.synchronize()
        return cs.snapshot(state), outs.loss.cpu().numpy(), outs.grad_norm.cpu().numpy()

    ref, loss_p, gn_p = run("plain")
    lr = cfg.train.optim.lr
    flat = lambda d: torch.cat([v.flatten().float() for v in d.values()])
    p0_, pp = flat(p0), flat(ref)
    for variant in args.variants:
        got, loss, gn = run(variant)
        pk = flat(got)
        sq = {k: (got[k].float() - ref[k].float()).square().sum().item() for k in p0}
        total = max(sum(sq.values()), 1e-30)
        print(json.dumps({
            "variant": variant,
            "updates_rel": ((pk - pp).norm() / (pp - p0_).norm()).item(),
            "frac_beyond_0.1lrK": ((pk - pp).abs() > 0.1 * lr * K).float().mean().item(),
            "loss_rel": float((np.abs(loss - loss_p) / np.abs(loss_p)).max()),
            "grad_norm_rel": float((np.abs(gn - gn_p) / np.abs(gn_p)).max()),
            "top": {k: v / total for k, v in sorted(sq.items(), key=lambda kv: -kv[1])[:3]},
        }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
