"""Native (C++) host data plane, loaded through ctypes.

Own copy of ``statecatcher_tpu/native``: the WAV decoder (``csrc/audio.cc``)
and the unigram tokenizer's Viterbi segmentation (``csrc/tokenizer.cc``),
built with g++ at first use into ``build/native/`` at the repository root
(ignored by git), named by a hash of the sources and the flags, so an edited
source is rebuilt and the package directory is never written.

Both have pure-Python versions with identical results (``data/audio.py``,
``tokenizer/unigram.py``), which run when g++ is missing, the build fails or
``STATECATCHER_NO_NATIVE=1``; ``available()`` says which path is live and
``load_error()`` why the native one is not.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

logger = logging.getLogger("statecatcher.native")

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("audio.cc", "tokenizer.cc")
FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_lib = None
_tried = False
_error: Optional[str] = None


def library_path() -> Path:
    """Where the library of the current sources and flags is built."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libstatecatcher_native-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    """g++ into a temporary name, then an atomic rename (a concurrent process
    never loads half a file).  Raises on failure."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *FLAGS, "-o", str(tmp), *(str(CSRC / n) for n in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ exited {proc.returncode}:\n{proc.stderr}")
    os.replace(tmp, out)


def _load():
    global _lib, _tried, _error
    if _tried:
        return _lib
    _tried = True
    _error = None
    if os.environ.get("STATECATCHER_NO_NATIVE") == "1":
        _error = "disabled by STATECATCHER_NO_NATIVE=1"
        return None
    path = library_path()
    try:
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        _error = f"native library unavailable: {e}"
        logger.warning("%s", _error)
        return None

    lib.sc_decode_wav.restype = ctypes.c_long
    lib.sc_decode_wav.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_size_t,
    ]
    lib.sc_wav_sample_rate.restype = ctypes.c_int
    lib.sc_wav_sample_rate.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib.sc_vocab_create.restype = ctypes.c_void_p
    lib.sc_vocab_create.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
    ]
    lib.sc_vocab_destroy.restype = None
    lib.sc_vocab_destroy.argtypes = [ctypes.c_void_p]
    lib.sc_viterbi_encode.restype = ctypes.c_int
    lib.sc_viterbi_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
    ]
    _lib = lib
    return _lib


def available() -> bool:
    """True when the native library is built and loaded (the native path is
    live); False when the pure-Python versions run."""
    return _load() is not None


def load_error() -> Optional[str]:
    """Why the native library is not live, or None when it is."""
    _load()
    return _error


# --------------------------------------------------------------------------- #
# Audio
# --------------------------------------------------------------------------- #
def decode_wav_native(data: bytes, target_sr: int):
    """Native WAV decode → float32 mono at target_sr, or None on failure."""
    lib = _load()
    if lib is None:
        return None
    n = lib.sc_decode_wav(data, len(data), target_sr, None, 0)
    if n < 0:
        return None
    out = np.empty(n, dtype=np.float32)
    lib.sc_decode_wav(
        data, len(data), target_sr,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n,
    )
    return out


# --------------------------------------------------------------------------- #
# Tokenizer
# --------------------------------------------------------------------------- #
class NativeVocab:
    """Viterbi-encode handle over a (piece, id, score) table."""

    def __init__(self, pieces: list[str], ids: list[int], scores: list[float]):
        lib = _load()
        if lib is None:
            raise RuntimeError(_error or "native library unavailable")
        self._lib = lib
        blobs = [p.encode("utf-8") for p in pieces]
        blob = b"".join(blobs)
        lens = np.array([len(b) for b in blobs], dtype=np.int32)
        ids_a = np.array(ids, dtype=np.int32)
        scores_a = np.array(scores, dtype=np.float32)
        self._handle = lib.sc_vocab_create(
            blob,
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ids_a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            scores_a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            len(pieces),
        )
        self._buf = np.empty(4096, dtype=np.int32)

    def encode_word(self, word: str):
        """Returns list of ids, or None if unsegmentable."""
        wb = word.encode("utf-8")
        n = self._lib.sc_viterbi_encode(
            self._handle, wb, len(wb),
            self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(self._buf),
        )
        if n < 0:
            return None
        return [int(x) for x in self._buf[:n]]

    def __del__(self):
        if getattr(self, "_handle", None) and getattr(self, "_lib", None):
            self._lib.sc_vocab_destroy(self._handle)
            self._handle = None
