"""statecatcher_tpu_torch — the PyTorch/CUDA port of statecatcher_tpu.

The JAX package beside it is the reference; this package re-implements its
serving, training and evaluation paths (LSTM, LucyRNN, xLSTM and RWKV
encoders, CTC and RNN-T) and its host data plane in PyTorch, with every TPU
kernel on those paths replaced by a CUDA kernel written for Hopper
(``ops/csrc``).  The port
imports ``torch`` and never JAX or anything of ``statecatcher_tpu``.

Layer map (module names follow the JAX package):

  streaming.py          — StreamingRecognizer: chunked encode + greedy decode
  decode.py             — CTC greedy decode
  train/                — the segment-group step, optimizers, loop, checkpoints
  parallel/             — multi-GPU: torchrun start-up, the (data, model) mesh
                          of ranks, tensor-parallel shards, the dry run
  models/               — SpeechModel → ASRModel → LSTMEncoder, LucyRNNEncoder
                          (LucyCell), XLSTMEncoder (MLSTMLayer) or RWKVEncoder
  data/, native/        — the host data plane: HTTP client and fake server,
                          local dataset, prefetch pipeline, C++ WAV decoder
  tokenizer/            — char, unigram (native Viterbi) and sentencepiece
  train_tokenizer.py, simulate.py, debug.py — the host-side tools
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
