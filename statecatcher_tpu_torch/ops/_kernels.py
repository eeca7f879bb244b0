"""Builds and loads the port's CUDA kernels (``ops/csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface, loaded with ``ctypes`` (pointers and the stream are
``c_void_p``).  Sources may include the headers of ``csrc/`` (``*.cuh``).
Libraries go to ``build/kernels/`` at the repository root, named by a hash of
the source, the headers and the flags, so an edited source or header is
rebuilt and an unchanged one is reused.  Nothing is built when this module is imported:
the first launch builds, and ``build_all`` builds every source at once, one
``nvcc`` process each, started together.

A missing ``nvcc`` or a failed build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
MAX_GRID_YZ = 65535     # CUDA's limit on a grid's y and z

# C signatures of each library's entry points: name → (restype, argtypes)
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "lucy_fused_lm_fwd": {
        "lucy_fused_lm_fwd": (_I, [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P]),
    },
    "lucy_fused_lm_bwd": {
        "lucy_fused_lm_bwd": (_I, [_I] + [_P] * 12 + [_I, _I, _I, _P]),
    },
    "ctc_lattice": {
        "ctc_alpha": (_I, [_P, _P, _P, _P, _I, _I, _I, _P]),
        "ctc_beta": (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _P]),
    },
    "rnnt_lattice": {
        "rnnt_alpha": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _P]),
        "rnnt_beta": (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
        "rnnt_band_alpha": (_I, [_P] * 5 + [_I] * 4 + [_P]),
        "rnnt_band_beta": (_I, [_P] * 6 + [_I] * 4 + [_P]),
    },
    "rnnt_joint": {
        "rnnt_joint_fwd": (_I, [_P] * 10 + [_I] * 7 + [_P]),
        "rnnt_joint_bwd": (_I, [_P] * 14 + [_I] * 8 + [_P]),
        "rnnt_joint_sizes": (_I, [_I, _I, _I, _P]),
    },
    "rnnt_band": {
        "rnnt_band_fwd": (_I, [_P] * 11 + [_I] * 10 + [_P]),
        "rnnt_band_bwd": (_I, [_P] * 16 + [_I] * 11 + [_P]),
        "rnnt_band_sizes": (_I, [_I, _I, _I, _P]),
    },
    "mlstm_fused": {
        "mlstm_fused_fwd": (_I, [_I] + [_P] * 13 + [_I] * 7 + [_P]),
        "mlstm_fused_fwd_work": (ctypes.c_longlong, [_I] * 6),
        "mlstm_fused_bwd": (_I, [_I] + [_P] * 21 + [_I] * 7 + [_P]),
        "mlstm_fused_bwd_work": (ctypes.c_longlong, [_I] * 6),
    },
    "mlstm_pallas": {
        "mlstm_pallas_fwd": (_I, [_P] * 13 + [_I] * 6 + [_P]),
        "mlstm_pallas_fwd_work": (ctypes.c_longlong, [_I] * 5),
    },
    "linear_scan": {
        "linear_scan_fwd": (_I, [_I] + [_P] * 4 + [_I] * 3 + [_P]),
        "linear_scan_rev": (_I, [_I] + [_P] * 3 + [_I] * 3 + [_P]),
    },
    "lucy_cell_scan": {
        "lucy_fused_cell_fwd": (_I, [_I] + [_P] * 6 + [_I] * 3 + [_P]),
        "lucy_dual_scan_fwd": (_I, [_I] + [_P] * 8 + [_I] * 3 + [_P]),
    },
}

# ptxas -v output and wall time of each build this process ran: name → dict
BUILD_LOG: dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the CUDA "
                       "kernels of statecatcher_tpu_torch cannot be built")


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start one nvcc build; returns (process, tmp path, final path, t0), or
    None when the library is already built."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out, time.perf_counter()


def _finish(name: str, started) -> None:
    proc, tmp, out, t0 = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)          # atomic: a concurrent process never loads half a file
    BUILD_LOG[name] = {"seconds": time.perf_counter() - t0, "ptxas": log}


def build_all() -> dict[str, dict]:
    """Build every kernel source not yet built, all nvcc processes at once."""
    started = {name: _start(name) for name in SIGNATURES}
    for name, st in started.items():
        if st is not None:
            _finish(name, st)
    return BUILD_LOG


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    st = _start(name)
    if st is not None:
        _finish(name, st)
    lib = ctypes.CDLL(str(_target(name)))
    for fn_name, (restype, argtypes) in SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib
