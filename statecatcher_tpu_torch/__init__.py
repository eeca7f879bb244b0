"""statecatcher_tpu_torch — the PyTorch/CUDA port of statecatcher_tpu.

The JAX package beside it is the reference; this package re-implements its
serving and training paths (LucyRNN and xLSTM encoders, CTC and RNN-T) in
PyTorch, with every TPU kernel on those paths replaced by a CUDA kernel
written for Hopper (``ops/csrc``).  The port
imports ``torch`` and never JAX or anything of ``statecatcher_tpu``.

Layer map (module names follow the JAX package):

  streaming.py          — StreamingRecognizer: chunked encode + greedy decode
  decode.py             — CTC greedy decode
  train/                — the segment-group step, optimizers, loop, checkpoints
  models/               — SpeechModel → ASRModel → LucyRNNEncoder (LucyCell)
                          or XLSTMEncoder (MLSTMLayer)
  ops/                  — the kernels' wrappers (CUDA on the card, their plain
                          versions on the CPU) and the torch code around them
  frontend.py           — STFT → mel → MFCC as full-f32 matmuls
  convert.py            — flax params ⇄ torch state_dict
  config.py             — the same config tree as the JAX package

Entry points take ``device="cuda"`` by default and raise when no card is
present; tests pass ``device="cpu"`` explicitly.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device) -> torch.device:
    """``device`` → ``torch.device``; a CUDA device without a card raises
    (the port never drops silently to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions"
        )
    return dev
