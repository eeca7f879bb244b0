"""Streaming recognizer: incremental encode + greedy CTC decode with the
encoder state carried from chunk to chunk.

Port of ``statecatcher_tpu/streaming.py`` for ``decoder="greedy"``, with the
same chunk bookkeeping: waveform pieces of any size are buffered; every
``chunk_samples = hop · chunk_frames`` new samples (plus the ``n_fft − hop``
lookahead the last frame needs) are featurised, encoded with the carry
threaded through, and greedily decoded, so the hypothesis grows as audio
arrives.  ``finish()`` zero-pads the remainder to a full chunk and keeps only
its valid frames at the stacked rate.  Everything runs under
``torch.inference_mode()``; per chunk, only the (T,) argmax crosses to the
host.  The ``"beam"`` and ``"rnnt"`` decoders are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from statecatcher_tpu_torch import resolve_device
from statecatcher_tpu_torch.config import Config
from statecatcher_tpu_torch.frontend import compute_features
from statecatcher_tpu_torch.models.asr import init_carry


class StreamingRecognizer:
    """Single-utterance streaming recognition with carried encoder state.

    ``model`` is an ``ASRModel`` or ``SpeechModel`` (CTC) whose parameters
    already live on ``device``.
    """

    def __init__(self, model, cfg: Config, tokenizer=None, chunk_frames: int = 32,
                 decoder: str = "greedy", blank_id: int = 0, device="cuda"):
        if decoder != "greedy":
            raise NotImplementedError(
                f"decoder={decoder!r} is not ported yet (ROADMAP.md queue 1); "
                "only 'greedy' is")
        dev = resolve_device(device)
        model_dev = next(model.parameters()).device
        if model_dev.type != dev.type or (dev.index is not None and model_dev.index != dev.index):
            raise ValueError(f"model is on {model_dev}, recognizer asked for {dev}")
        self.device = model_dev
        self.model = model
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.decoder = decoder
        self.blank_id = blank_id
        fe = cfg.frontend
        self.stack_order = max(1, cfg.model.stack_order)
        if chunk_frames % self.stack_order != 0:
            raise ValueError(
                f"chunk_frames ({chunk_frames}) must be a multiple of "
                f"model.stack_order ({self.stack_order}) so no frames are "
                "dropped at the frame-stacking trim")
        self.chunk_frames = chunk_frames
        # samples consumed per encoder chunk; win−hop lookahead stays buffered
        self.chunk_samples = fe.hop_length * chunk_frames
        self.lookahead = fe.n_fft - fe.hop_length
        self.reset()

    # ------------------------------------------------------------------ #
    def _encode_chunk(self, chunk: np.ndarray) -> torch.Tensor:
        """One chunk of samples → (1, T, V) float32 log-probs; advances the
        carry."""
        with torch.inference_mode():
            audio = torch.from_numpy(chunk[None]).to(self.device)
            feats = compute_features(audio, self.cfg.frontend)
            logits, self._carry = self.model(feats, self._carry, None)
            return torch.log_softmax(logits.to(torch.float32), dim=-1)

    def _step_chunk(self, chunk: np.ndarray) -> np.ndarray:
        """Encode one full chunk and return its (T,) argmax on the host."""
        lp = self._encode_chunk(chunk)
        return torch.argmax(lp[0], dim=-1).cpu().numpy()

    def accept_waveform(self, samples: np.ndarray):
        """Feed samples (float32, model sample rate); decode what completes."""
        self._buffer = np.concatenate([self._buffer, samples.astype(np.float32)])
        need = self.chunk_samples + self.lookahead
        while len(self._buffer) >= need:
            chunk = self._buffer[:need]
            self._buffer = self._buffer[self.chunk_samples:]
            self._absorb_greedy(self._step_chunk(chunk))

    def _absorb_greedy(self, preds: np.ndarray):
        for tok in preds.tolist():
            if tok != self.blank_id and tok != self._prev_argmax:
                self._tokens.append(tok)
            self._prev_argmax = tok

    def finish(self):
        """Flush remaining buffered samples (zero-padded to a full chunk)."""
        if len(self._buffer) > self.lookahead:
            pad = self.chunk_samples + self.lookahead - len(self._buffer)
            # valid frames at the ENCODER rate (post frame-stacking)
            n_valid = ((len(self._buffer) - self.lookahead)
                       // self.cfg.frontend.hop_length // self.stack_order)
            chunk = np.concatenate([self._buffer, np.zeros(pad, np.float32)])
            self._buffer = np.zeros(0, np.float32)
            lp = self._encode_chunk(chunk)[:, :max(n_valid, 0)]
            if lp.shape[1]:
                self._absorb_greedy(torch.argmax(lp[0], dim=-1).cpu().numpy())

    # ------------------------------------------------------------------ #
    @property
    def tokens(self) -> list[int]:
        return list(self._tokens)

    @property
    def committed_tokens(self) -> list[int]:
        """For greedy CTC every emitted token is final."""
        return list(self._tokens)

    @property
    def text(self) -> str:
        if self.tokenizer is None:
            return " ".join(map(str, self.tokens))
        return self.tokenizer.decode_ids(self.tokens)

    def reset(self):
        self._buffer = np.zeros(0, dtype=np.float32)
        self._carry = init_carry(self.cfg.model, 1, device=self.device)
        self._tokens: list[int] = []
        self._prev_argmax = -1
