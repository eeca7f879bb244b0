"""Debug, tracing and sanitizer hooks (port of ``statecatcher_tpu/debug.py``).

  * ``enable_debug()`` / ``disable_debug()`` — autograd's anomaly mode with
    NaN checks (``torch.autograd.set_detect_anomaly(True, check_nan=True)``),
    the counterpart of ``jax_debug_nans``: a backward function that returns
    a NaN raises, with the traceback of the forward operation that made it.
    It does not catch what JAX's flag does outside the backward: a NaN made
    by a forward operation (under ``torch.no_grad`` or not) that never
    reaches a gradient, and infinities (``jax_debug_infs``) anywhere.  The
    training loop turns it off again when ``train()`` returns or raises.
  * ``check_carry(carry)`` — the carry's invariant on fetched values:
    finite, and batch-major (``batch_size`` rows on axis 0).
  * ``profile(log_dir)`` — ``torch.profiler`` around a block (the host and,
    on a card, CUDA activity), written as a Chrome/Perfetto trace
    ``trace-<pid>-<n>.json`` into ``log_dir``.
  * ``kernel_interpret_mode()`` — every kernel slot of the model and
    training paths routed to its plain PyTorch version, on any device: the
    caller asks for it (JAX's ``force_tpu_interpret_mode``); it is never a
    fall-back.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import os

import torch

logger = logging.getLogger("statecatcher.debug")
_traces = itertools.count()


def enable_debug():
    """Anomaly mode with NaN checks (infinities are not checked)."""
    torch.autograd.set_detect_anomaly(True, check_nan=True)
    logger.info("debug mode: autograd anomaly detection on (NaNs checked, infinities not)")


def disable_debug():
    torch.autograd.set_detect_anomaly(False)


def _leaves(tree, prefix: str):
    if tree is None:
        return
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def check_carry(carry, batch_size: int | None = None) -> int:
    """Host-side invariant check on a carry (a dict, list or tuple of
    tensors, nested or not).  Raises ``FloatingPointError`` for a
    non-finite value and ``ValueError`` for a leaf whose axis 0 is not
    ``batch_size``; returns the number of leaves checked."""
    n = 0
    for label, leaf in _leaves(carry, "carry"):
        t = torch.as_tensor(leaf)
        if not bool(torch.isfinite(t).all()):
            raise FloatingPointError(f"{label} contains non-finite values")
        if batch_size is not None and (t.ndim == 0 or t.shape[0] != batch_size):
            raise ValueError(f"{label} not batch-major: shape {tuple(t.shape)}, expected "
                             f"leading {batch_size}")
        n += 1
    return n


@contextlib.contextmanager
def profile(log_dir: str):
    """torch.profiler trace of the block (view in Perfetto or chrome://tracing)."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        path = os.path.join(log_dir, f"trace-{os.getpid()}-{next(_traces)}.json")
        prof.export_chrome_trace(path)
        logger.info("profiler trace written to %s", path)


def kernel_slots() -> list:
    """(module, attribute, plain version) of every kernel slot: the name a
    wrapper launches its CUDA kernel through, and the plain PyTorch version
    that computes the same function."""
    from statecatcher_tpu_torch.ops import (
        ctc_lattice,
        lucy_fused_lm,
        lucy_pallas,
        mlstm_fused,
        mlstm_pallas,
        rnnt_band,
        rnnt_joint,
        rnnt_lattice,
    )
    from statecatcher_tpu_torch.models.xlstm import mlstm_chunkwise

    return [
        (lucy_fused_lm, "_fwd_kernel", lucy_fused_lm.lucy_cell_fused_lm_ref),
        (lucy_fused_lm, "_bwd_kernel", lucy_fused_lm.lucy_cell_fused_lm_bwd_ref),
        (ctc_lattice, "ctc_alpha", ctc_lattice.ctc_alpha_ref),
        (ctc_lattice, "ctc_beta", ctc_lattice.ctc_beta_ref),
        (lucy_pallas, "linear_scan_fwd", lucy_pallas.linear_scan_ref),
        (lucy_pallas, "linear_scan_rev", lucy_pallas.linear_scan_rev_ref),
        (rnnt_joint, "rnnt_joint_fwd", rnnt_joint.joint_blank_emit_ref),
        (rnnt_joint, "rnnt_joint_bwd", rnnt_joint.joint_blank_emit_bwd_ref),
        (rnnt_lattice, "rnnt_alpha", rnnt_lattice.rnnt_alpha_ref),
        (rnnt_lattice, "rnnt_beta", rnnt_lattice.rnnt_beta_ref),
        (rnnt_band, "rnnt_band_fwd", rnnt_band.joint_blank_emit_banded_ref),
        (rnnt_band, "rnnt_band_bwd", rnnt_band.joint_blank_emit_banded_bwd_ref),
        (rnnt_band, "rnnt_band_alpha", rnnt_band.rnnt_band_alpha_ref),
        (rnnt_band, "rnnt_band_beta", rnnt_band.rnnt_band_beta_ref),
        (mlstm_fused, "mlstm_fused_fwd", mlstm_fused.mlstm_fused_fwd_ref),
        (mlstm_fused, "mlstm_fused_bwd", mlstm_fused.mlstm_fused_bwd_ref),
        (mlstm_pallas, "mlstm_pallas_fwd", mlstm_chunkwise),
        (lucy_pallas, "_fused_cell_kernel", lucy_pallas.lucy_fused_cell_ref),
        (lucy_pallas, "_dual_scan_kernel", lucy_pallas.lucy_dual_scan_ref),
    ]


@contextlib.contextmanager
def kernel_interpret_mode():
    """Route every kernel slot to its plain version for the block, so a
    path on the card runs the same function without its CUDA kernels."""
    slots = kernel_slots()
    saved = [getattr(mod, name) for mod, name, _ in slots]
    for mod, name, plain in slots:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for (mod, name, _), kernel in zip(slots, saved):
            setattr(mod, name, kernel)
