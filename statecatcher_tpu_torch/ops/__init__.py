"""Kernels and their plain versions.

  scan.py           — sequential linear scan (plain)
  lucy_gates.py     — LucyRNN gate chain (plain)
  lucy_fused_lm.py  — fused cell: CUDA kernel wrapper + plain version
  _kernels.py       — nvcc build + ctypes loader for csrc/*.cu
"""
