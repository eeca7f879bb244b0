"""Streaming recognizer: incremental encode + greedy decode with the encoder
state carried from chunk to chunk.

Port of ``statecatcher_tpu/streaming.py`` for ``decoder="greedy"`` (CTC),
``decoder="beam"`` (CTC prefix beam) and ``decoder="rnnt"`` (greedy
transducer), with the same chunk bookkeeping:
waveform pieces of any size are buffered; every ``chunk_samples = hop ·
chunk_frames`` new samples (plus the ``n_fft − hop`` lookahead the last frame
needs) are featurised, encoded with the carry threaded through, and decoded,
so the hypothesis grows as audio arrives.  ``finish()`` zero-pads the
remainder to a full chunk and keeps only its valid frames at the stacked
rate.  Everything runs under ``torch.inference_mode()``.

  * greedy: per chunk, only the (T,) argmax crosses to the host.
  * rnnt: per chunk the encoder output is projected to the join space and
    the greedy decode state (``rnnt_decode.py``) advances on the device; the
    emitted tokens are drained to the host once the buffer may be half full
    (at most ``max_symbols`` = 4 emissions per frame), so streams of any
    length fit a fixed ``max_out`` buffer.
  * beam: per chunk the prefix beam state (``beam.py``) advances on the
    device and the best beam is packed there as ``[len, toks…]``, so
    ``tokens`` costs one small copy; once the buffers may be half full (at
    most one CTC emission per frame) the prefix every live beam agrees on is
    committed to the host (``beam_commit``, forcing along the best beam to
    keep half the buffer free), so streams of any length fit ``max_out``.
"""

from __future__ import annotations

import numpy as np
import torch

from statecatcher_tpu_torch import resolve_device
from statecatcher_tpu_torch.beam import beam_commit, beam_hypotheses, ctc_beam_search
from statecatcher_tpu_torch.config import Config
from statecatcher_tpu_torch.frontend import compute_features
from statecatcher_tpu_torch.models.asr import init_carry
from statecatcher_tpu_torch.rnnt_decode import (
    rnnt_decode_init,
    rnnt_drain,
    rnnt_greedy_decode,
    rnnt_state_to_lists,
)

_RNNT_MAX_SYMBOLS = 4


class StreamingRecognizer:
    """Single-utterance streaming recognition with carried encoder state.

    ``model`` is an ``ASRModel`` or ``SpeechModel`` whose parameters already
    live on ``device``; ``decoder="rnnt"`` needs a ``SpeechModel`` in RNN-T
    mode.  ``beam`` is the CTC beam width.
    """

    def __init__(self, model, cfg: Config, tokenizer=None, chunk_frames: int = 32,
                 decoder: str = "greedy", beam: int = 8, blank_id: int = 0,
                 max_out: int = 512, device="cuda"):
        if decoder not in ("greedy", "beam", "rnnt"):
            raise ValueError(f"decoder must be 'greedy', 'beam' or 'rnnt', got {decoder!r}")
        if decoder == "rnnt" and getattr(model, "mode", None) != "rnnt":
            raise ValueError("decoder='rnnt' needs a SpeechModel built with mode='rnnt'")
        dev = resolve_device(device)
        model_dev = next(model.parameters()).device
        if model_dev.type != dev.type or (dev.index is not None and model_dev.index != dev.index):
            raise ValueError(f"model is on {model_dev}, recognizer asked for {dev}")
        self.device = model_dev
        self.model = model
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.decoder = decoder
        self.beam = beam
        self.blank_id = blank_id
        self.max_out = max_out
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
        if decoder == "rnnt":
            with torch.inference_mode():
                self._rnnt_tables = tuple(x.to(torch.float32)
                                          for x in model.rnnt_decode_tables())
        self.reset()

    # ------------------------------------------------------------------ #
    def _encode_chunk(self, chunk: np.ndarray) -> torch.Tensor:
        """One chunk of samples → (1, T, V) float32 log-probs (greedy, beam)
        or (1, T, J) float32 join-space projections (rnnt); advances the
        carry."""
        with torch.inference_mode():
            audio = torch.from_numpy(chunk[None]).to(self.device)
            feats = compute_features(audio, self.cfg.frontend)
            logits, self._carry = self.model(feats, self._carry, None)
            if self.decoder == "rnnt":
                return self.model.rnnt_project_encoder(logits).to(torch.float32)
            return torch.log_softmax(logits.to(torch.float32), dim=-1)

    def _step_chunk(self, chunk: np.ndarray):
        """Encode one full chunk and decode it: the (T,) argmax on the host
        (greedy), or the transducer or beam state advanced on the device
        (rnnt, beam; beam also packs its best beam there)."""
        out = self._encode_chunk(chunk)
        if self.decoder == "rnnt":
            self._advance_rnnt(out)
            return None
        if self.decoder == "beam":
            self._advance_beam(out)
            with torch.inference_mode():
                st = self._beam_state
                b = torch.argmax(self._totals[0])
                self._best_packed = torch.cat([st.lens[0, b][None], st.toks[0, b]])
            return None
        return torch.argmax(out[0], dim=-1).cpu().numpy()

    def _advance_beam(self, lp: torch.Tensor) -> None:
        with torch.inference_mode():
            self._beam_state, self._totals = ctc_beam_search(
                lp, torch.tensor([lp.shape[1]], device=self.device), beam=self.beam,
                blank_id=self.blank_id, max_len=self.max_out, init_state=self._beam_state)
        self._best_packed = None
        self._best_resid_host = None

    def _commit_beam(self) -> None:
        """Commit what every live beam agrees on, keeping half the buffer
        free; the best beam's residual comes back from the host arrays."""
        self._beam_state, com, best_resid, fill = beam_commit(
            self._beam_state, self._totals, reserve=self.max_out // 2, return_best=True)
        with torch.inference_mode():
            # forced commits can prune beams: refresh the totals
            self._totals = torch.logaddexp(self._beam_state.p_b, self._beam_state.p_nb)
        self._committed.extend(com[0])
        self._fill_bound = fill
        self._best_packed = None                      # the residual shifted
        self._best_resid_host = best_resid[0]

    def _advance_rnnt(self, enc_p: torch.Tensor) -> None:
        with torch.inference_mode():
            self._rnnt_state = rnnt_greedy_decode(
                enc_p, *self._rnnt_tables,
                torch.tensor([enc_p.shape[1]], device=self.device), blank_id=self.blank_id,
                max_symbols=_RNNT_MAX_SYMBOLS, init_state=self._rnnt_state)

    def _drain(self) -> None:
        self._rnnt_state, com = rnnt_drain(self._rnnt_state)
        self._committed.extend(com[0])
        self._fill_bound = 0

    def accept_waveform(self, samples: np.ndarray):
        """Feed samples (float32, model sample rate); decode what completes."""
        self._buffer = np.concatenate([self._buffer, samples.astype(np.float32)])
        need = self.chunk_samples + self.lookahead
        t_enc = self.chunk_frames // self.stack_order
        while len(self._buffer) >= need:
            chunk = self._buffer[:need]
            self._buffer = self._buffer[self.chunk_samples:]
            if self.decoder == "rnnt":
                self._step_chunk(chunk)
                # a host-side bound on the buffer's fill, so no per-chunk sync
                self._fill_bound += t_enc * _RNNT_MAX_SYMBOLS
                if self._fill_bound >= self.max_out // 2:
                    self._drain()
            elif self.decoder == "beam":
                self._step_chunk(chunk)
                self._fill_bound += t_enc                 # ≤ 1 CTC emission a frame
                if self._fill_bound >= self.max_out // 2:
                    self._commit_beam()
            else:
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
            out = self._encode_chunk(chunk)[:, :max(n_valid, 0)]
            if not out.shape[1]:
                return
            if self.decoder == "rnnt":
                self._advance_rnnt(out)
                if int(self._rnnt_state.out_len[0]) >= self.max_out // 2:
                    self._drain()
            elif self.decoder == "beam":
                self._advance_beam(out)
                if int(self._beam_state.lens.max()) >= self.max_out // 2:
                    self._beam_state, com = beam_commit(self._beam_state, self._totals,
                                                        reserve=self.max_out // 2)
                    with torch.inference_mode():
                        self._totals = torch.logaddexp(self._beam_state.p_b,
                                                       self._beam_state.p_nb)
                    self._committed.extend(com[0])
            else:
                self._absorb_greedy(torch.argmax(out[0], dim=-1).cpu().numpy())

    # ------------------------------------------------------------------ #
    @property
    def tokens(self) -> list[int]:
        """Full current hypothesis (rnnt, beam: the committed prefix and the
        buffer's residual, for beam the best beam's)."""
        if self.decoder == "rnnt":
            return self._committed + rnnt_state_to_lists(self._rnnt_state)[0]
        if self.decoder == "greedy":
            return list(self._tokens)
        if self._beam_state is None:
            return list(self._committed)
        if self._best_packed is not None:
            packed = self._best_packed.cpu().numpy()          # one small copy
            return self._committed + packed[1:1 + int(packed[0])].tolist()
        if self._best_resid_host is not None:                 # after a commit: no copy
            return self._committed + list(self._best_resid_host)
        hyps = beam_hypotheses(self._beam_state, self._totals)[0]
        return self._committed + (hyps[0][1] if hyps else [])

    @property
    def committed_tokens(self) -> list[int]:
        """Tokens that can no longer change: for greedy CTC every emitted
        token; for rnnt the drained ones; for beam the prefix every live
        beam agreed on at a commit."""
        if self.decoder == "greedy":
            return list(self._tokens)
        return list(self._committed)

    @property
    def committed_text(self) -> str:
        """``committed_tokens`` decoded (ids joined by spaces without a
        tokenizer)."""
        if self.tokenizer is None:
            return " ".join(map(str, self.committed_tokens))
        return self.tokenizer.decode_ids(self.committed_tokens)

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
        self._committed: list[int] = []
        self._fill_bound = 0
        self._rnnt_state = (rnnt_decode_init(1, self.max_out, self.blank_id, self.device)
                            if self.decoder == "rnnt" else None)
        self._beam_state = None       # built by the first chunk's search
        self._totals = None
        self._best_packed = None      # device [len, toks…] of the best beam
        self._best_resid_host = None  # the best beam's residual after a commit
