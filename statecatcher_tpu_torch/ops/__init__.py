"""Kernels and their plain versions.

  scan.py           — sequential linear scan (plain)
  lucy_gates.py     — LucyRNN gate chain (plain)
  lucy_fused_lm.py  — fused cell: CUDA kernel wrapper + plain version
  _kernels.py       — nvcc build + ctypes loader for csrc/*.cu
"""


def kernel_wrappers() -> dict:
    """Every CUDA kernel wrapper of the port, by name; each counts its
    launches in ``.launches`` (on CUDA tensors only)."""
    from statecatcher_tpu_torch.ops import (ctc_lattice, lucy_fused_lm, lucy_pallas, mlstm_fused,
                                            mlstm_pallas, rnnt_band, rnnt_joint, rnnt_lattice)

    fns = (lucy_fused_lm.lucy_cell_fused_lm, lucy_fused_lm.lucy_cell_fused_lm_bwd,
           ctc_lattice.ctc_alpha, ctc_lattice.ctc_beta, lucy_pallas.linear_scan_fwd,
           lucy_pallas.linear_scan_rev, lucy_pallas.lucy_fused_cell, lucy_pallas.lucy_dual_scan,
           rnnt_joint.rnnt_joint_fwd, rnnt_joint.rnnt_joint_bwd, rnnt_lattice.rnnt_alpha,
           rnnt_lattice.rnnt_beta, rnnt_band.rnnt_band_fwd, rnnt_band.rnnt_band_bwd,
           rnnt_band.rnnt_band_alpha, rnnt_band.rnnt_band_beta, mlstm_fused.mlstm_fused_fwd,
           mlstm_fused.mlstm_fused_bwd, mlstm_pallas.mlstm_pallas_fwd)
    return {f.__name__: f for f in fns}


def launch_counts() -> dict:
    """Each kernel wrapper's launches so far in this process."""
    return {name: f.launches for name, f in kernel_wrappers().items()}
