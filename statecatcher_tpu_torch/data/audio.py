"""Audio decode: pure-numpy WAV reader plus an optional ffmpeg subprocess path.

Own copy of ``statecatcher_tpu/data/audio.py`` (the port imports nothing of
the JAX package), without its native C++ WAV decoder.

The reference pipes every download through ffmpeg → 16-bit PCM mono WAV →
soundfile → ``float32 / 32767`` (reference dataset.py:155-164).  Neither
ffmpeg nor soundfile is required here: the primary path is a self-contained
RIFF/WAVE parser (PCM16/PCM32/float32, with channel downmix and linear
resampling); when an ``ffmpeg`` binary IS present, arbitrary codecs (mp3/ogg/
aac podcasts) go through the same subprocess pipeline as the reference.
"""

from __future__ import annotations

import shutil
import struct
import subprocess
from typing import Optional

import numpy as np

_FFMPEG = shutil.which("ffmpeg")
FFMPEG_TIMEOUT_S = 600          # an hour-long recording decodes in well under this


def decode_audio_fast(data: bytes, target_sr: int) -> np.ndarray:
    """``decode_audio`` that keeps int16 PCM when a lossless passthrough
    exists.

    Returns mono int16 at ``target_sr`` when ``data`` is a mono PCM16
    RIFF/WAVE already at ``target_sr`` — the production fast path: the train
    loop's compact host→device transfer re-quantizes float audio back to
    int16 anyway, and the float round-trip (pcm/32767 → rint(f·32767)) is
    bit-exact for every int16 value, so skipping it changes nothing
    downstream while saving two full passes and half the stacking bytes.
    Everything else falls back to ``decode_audio`` (float32).
    """
    if _is_wav(data):
        parsed = _parse_wav_chunks(data)
        if parsed is not None:
            (audio_format, channels, sr, bits), raw = parsed
            if (audio_format == 1 and bits == 16 and channels == 1
                    and sr == target_sr):
                return np.frombuffer(raw[: len(raw) & ~1], dtype="<i2").copy()
    return decode_audio(data, target_sr)


def decode_audio(data: bytes, target_sr: int) -> np.ndarray:
    """Decode arbitrary audio bytes → float32 mono at ``target_sr``.

    Scaling matches the reference's int16 → float32/32767 convention
    (dataset.py:163-164).
    """
    if _is_wav(data):
        # (the JAX package's default path here is its native C++ decoder,
        # not ported; the output length is sized as that decoder sizes it)
        wav, sr, _ = read_wav_bytes(data)
        wav = to_mono(wav)
        if sr != target_sr:
            wav = resample_linear(wav, sr, target_sr,
                                  n_out=resampled_count(len(wav), sr, target_sr))
        return wav
    if _FFMPEG is None:
        raise RuntimeError(
            "Non-WAV audio requires ffmpeg, which is not available on this host"
        )
    return _ffmpeg_decode(data, target_sr)


def _ffmpeg_decode(data: bytes, target_sr: int) -> np.ndarray:
    # Same decode contract as reference dataset.py:155-161: pcm_s16le, mono,
    # resampled by ffmpeg.  We ask for raw s16le instead of WAV to skip the
    # container round-trip.
    proc = subprocess.run(
        [_FFMPEG, "-i", "pipe:0", "-f", "s16le", "-acodec", "pcm_s16le",
         "-ac", "1", "-ar", str(target_sr), "pipe:1"],
        input=data, capture_output=True, timeout=FFMPEG_TIMEOUT_S,
    )
    if proc.returncode != 0:
        raise RuntimeError("FFmpeg error occurred:\n" + proc.stderr.decode("utf-8", "replace"))
    pcm = np.frombuffer(proc.stdout, dtype="<i2")
    return pcm.astype(np.float32) / 32767.0


def _is_wav(data: bytes) -> bool:
    return len(data) >= 12 and data[:4] == b"RIFF" and data[8:12] == b"WAVE"


def _parse_wav_chunks(data: bytes):
    """RIFF walk → ((format, channels, sr, bits), data_memoryview) or None.

    The payload is returned as a zero-copy memoryview — slicing multi-MB
    podcast payloads as bytes would memcpy them once per chunk probe."""
    pos = 12
    fmt = None
    fmt_body = b""
    raw = None
    n = len(data)
    view = memoryview(data)
    while pos + 8 <= n:
        cid, csize = struct.unpack_from("<4sI", data, pos)
        pos += 8
        body = view[pos:pos + csize]
        if cid == b"fmt ":
            fmt = struct.unpack_from("<HHIIHH", body, 0)
            fmt_body = bytes(body[:32])
        elif cid == b"data":
            raw = body
        pos += csize + (csize & 1)  # chunks are word-aligned
        if fmt is not None and raw is not None:
            break
    if fmt is None or raw is None:
        return None
    audio_format, channels, sr, _, _, bits = fmt
    if audio_format == 0xFFFE and len(fmt_body) >= 26:
        # WAVE_FORMAT_EXTENSIBLE: real format code is the first word of the
        # SubFormat GUID at offset 24 of the fmt chunk.
        audio_format = struct.unpack_from("<H", fmt_body, 24)[0]
    return (audio_format, channels, sr, bits), raw


def read_wav_bytes(data: bytes) -> tuple[np.ndarray, int, int]:
    """Parse a RIFF/WAVE blob → (float32 samples [S, C] or [S], sr, channels)."""
    if not _is_wav(data):
        raise ValueError("Not a RIFF/WAVE file")
    parsed = _parse_wav_chunks(data)
    if parsed is None:
        raise ValueError("WAV missing fmt/data chunk")
    (audio_format, channels, sr, bits), raw = parsed
    if audio_format == 1 and bits == 16:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32767.0
    elif audio_format == 1 and bits == 32:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483647.0
    elif audio_format == 1 and bits == 8:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 127.0
    elif audio_format == 3 and bits == 32:
        x = np.frombuffer(raw, dtype="<f4").astype(np.float32)
    else:
        raise ValueError(f"Unsupported WAV format {audio_format}/{bits}bit")
    if channels > 1:
        x = x[: (len(x) // channels) * channels].reshape(-1, channels)
    return x, sr, channels


def write_wav_bytes(x: np.ndarray, sr: int) -> bytes:
    """Encode float32 mono samples → 16-bit PCM WAV bytes (for fixtures)."""
    pcm = np.clip(np.asarray(x, dtype=np.float32), -1.0, 1.0)
    pcm16 = (pcm * 32767.0).astype("<i2")
    body = pcm16.tobytes()
    hdr = b"RIFF" + struct.pack("<I", 36 + len(body)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sr, sr * 2, 2, 16)
    hdr += b"data" + struct.pack("<I", len(body))
    return hdr + body


def to_mono(x: np.ndarray) -> np.ndarray:
    if x.ndim == 2:
        return x.mean(axis=1).astype(np.float32)
    return x.astype(np.float32, copy=False)


def resampled_count(n: int, sr_in: int, sr_out: int) -> int:
    """Samples of ``n`` resampled from ``sr_in`` to ``sr_out``, rounded half
    away from zero (``llround``, as the JAX package's native decoder,
    ``native/csrc/audio.cc:76-79``)."""
    if sr_in == sr_out or n == 0:
        return n
    exact = n * sr_out / sr_in
    whole = int(exact)
    return whole + 1 if exact - whole >= 0.5 else whole


def resample_linear(x: np.ndarray, sr_in: int, sr_out: int,
                    n_out: Optional[int] = None) -> np.ndarray:
    """Linear-interpolation resampler (fallback when ffmpeg is unavailable).
    ``n_out`` defaults to the numpy fallback's length (Python's ``round``,
    halves to even)."""
    if sr_in == sr_out or len(x) == 0:
        return x
    if n_out is None:
        n_out = int(round(len(x) * sr_out / sr_in))
    t_out = np.arange(n_out, dtype=np.float64) * (sr_in / sr_out)
    return np.interp(t_out, np.arange(len(x), dtype=np.float64), x).astype(np.float32)
