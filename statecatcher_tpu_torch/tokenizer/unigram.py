"""Unigram-LM subword tokenizer: EM-trained piece inventory, Viterbi encode.

Own copy of ``statecatcher_tpu/tokenizer/unigram.py``; encode runs the
native Viterbi (``native.NativeVocab``) when the library is live, else the
Python one, with the same tie-breaking.

Self-contained replacement for the reference's sentencepiece trainer
(reference train_sentencepiece.py:31-72 — unigram model, vocab 1024,
character coverage ≈ 1.0, digits/punctuation as user symbols).  Same word
convention as sentencepiece: whitespace becomes the ``▁`` word-boundary
marker, so token streams decode unambiguously.

Reserved ids: 0 = blank (the CTC contract — never emitted by encode),
1 = <unk>.  Single characters are always kept in the inventory so encode has
full coverage of the training charset.
"""

from __future__ import annotations

import json
import math
from collections import Counter

from statecatcher_tpu_torch import native

_WS = "▁"  # ▁


def _words_with_marker(corpus: list[str]) -> Counter:
    words = Counter()
    for line in corpus:
        for w in line.split():
            words[_WS + w] += 1
    return words


def _viterbi_segment(word: str, logp: dict[str, float], max_len: int) -> list[str]:
    """Best segmentation of ``word`` under piece log-probs (known chars only)."""
    n = len(word)
    best = [-math.inf] * (n + 1)
    back: list[int] = [0] * (n + 1)
    best[0] = 0.0
    for i in range(1, n + 1):
        for j in range(max(0, i - max_len), i):
            piece = word[j:i]
            lp = logp.get(piece)
            if lp is not None and best[j] + lp > best[i]:
                best[i] = best[j] + lp
                back[i] = j
    if not math.isfinite(best[n]):
        return []  # unsegmentable (unknown character present)
    pieces = []
    i = n
    while i > 0:
        j = back[i]
        pieces.append(word[j:i])
        i = j
    return pieces[::-1]


class UnigramTokenizer:
    BLANK = 0
    UNK = 1

    def __init__(self, pieces: list[str], scores: list[float]):
        """pieces/scores exclude the two reserved ids."""
        self._pieces = ["<blk>", "<unk>"] + list(pieces)
        self._scores = [0.0, 0.0] + [float(s) for s in scores]
        self._id_of = {p: i for i, p in enumerate(self._pieces) if i >= 2}
        self._logp = {p: self._scores[i] for p, i in self._id_of.items()}
        self._max_len = max((len(p) for p in pieces), default=1)
        self._native = None
        if native.available():
            ids = [self._id_of[p] for p in pieces]
            sc = [self._logp[p] for p in pieces]
            self._native = native.NativeVocab(list(pieces), ids, sc)

    # ------------------------------------------------------------------ #
    # Training
    # ------------------------------------------------------------------ #
    @classmethod
    def train(
        cls,
        corpus: list[str],
        vocab_size: int = 1024,
        max_piece_len: int = 8,
        seed_factor: int = 4,
        em_iters: int = 4,
        prune_frac: float = 0.2,
        user_symbols: list[str] | None = None,
    ) -> "UnigramTokenizer":
        words = _words_with_marker(corpus)
        if not words:
            raise ValueError("Empty corpus")

        # --- seed inventory: frequent substrings scored by count · len ----- #
        sub_counts: Counter = Counter()
        for w, c in words.items():
            L = len(w)
            for i in range(L):
                for j in range(i + 1, min(L, i + max_piece_len) + 1):
                    sub_counts[w[i:j]] += c
        chars = {p for p in sub_counts if len(p) == 1}
        multi = [p for p in sub_counts if len(p) > 1]
        multi.sort(key=lambda p: -sub_counts[p] * len(p))
        seed_target = max(vocab_size * seed_factor, vocab_size + len(chars))
        inventory = set(chars) | set(multi[: seed_target - len(chars)])
        for sym in user_symbols or []:
            inventory.add(sym)

        # initial log-probs from raw substring counts
        total = sum(sub_counts[p] for p in inventory)
        logp = {p: math.log(sub_counts.get(p, 1) / total) for p in inventory}

        # --- EM + prune loop (hard EM via Viterbi counts) ----------------- #
        n_reserved = 2
        target = max(vocab_size - n_reserved, len(chars))
        max_len = max_piece_len
        while True:
            for _ in range(em_iters):
                counts: Counter = Counter()
                for w, c in words.items():
                    for p in _viterbi_segment(w, logp, max_len):
                        counts[p] += c
                tot = sum(counts.values()) or 1
                new_logp = {}
                for p in logp:
                    if len(p) == 1 or p in (user_symbols or []):
                        # always keep; smooth unused chars heavily down
                        new_logp[p] = math.log((counts.get(p, 0) + 0.5) / tot)
                    elif counts.get(p, 0) > 0:
                        new_logp[p] = math.log(counts[p] / tot)
                logp = new_logp
            if len(logp) <= target:
                break
            # prune lowest-likelihood multi-char pieces
            multi_pieces = sorted(
                (p for p in logp if len(p) > 1 and p not in (user_symbols or [])),
                key=lambda p: logp[p],
            )
            n_drop = max(1, int(len(multi_pieces) * prune_frac))
            n_drop = min(n_drop, len(logp) - target)
            if n_drop <= 0 or not multi_pieces:
                break
            for p in multi_pieces[:n_drop]:
                del logp[p]

        pieces = sorted(logp.keys(), key=lambda p: (-logp[p], p))[:target]
        scores = [logp[p] for p in pieces]
        return cls(pieces, scores)

    # ------------------------------------------------------------------ #
    # Encode / decode
    # ------------------------------------------------------------------ #
    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        for w in text.split():
            word = _WS + w
            if self._native is not None:
                native_ids = self._native.encode_word(word)
                if native_ids is not None:
                    ids.extend(native_ids)
                    continue
                ids.extend(self._encode_with_unk(word))
                continue
            seg = _viterbi_segment(word, self._logp, self._max_len)
            if not seg:
                # unknown character(s): segment around them, emit UNK
                ids.extend(self._encode_with_unk(word))
            else:
                ids.extend(self._id_of[p] for p in seg)
        return ids

    def _encode_with_unk(self, word: str) -> list[int]:
        out = []
        run = ""
        for ch in word:
            if ch in self._logp or (run == "" and ch == _WS):
                run += ch
            else:
                if run:
                    out.extend(
                        self._id_of[p]
                        for p in _viterbi_segment(run, self._logp, self._max_len)
                    )
                    run = ""
                out.append(self.UNK)
        if run:
            seg = _viterbi_segment(run, self._logp, self._max_len)
            if seg:
                out.extend(self._id_of[p] for p in seg)
            elif run:
                out.append(self.UNK)
        return out

    def decode_ids(self, ids: list[int]) -> str:
        text = "".join(
            self._pieces[i]
            for i in ids
            if i not in (self.BLANK, self.UNK) and 0 <= i < len(self._pieces)
        )
        # collapse marker runs (e.g. around dropped <unk>) into single spaces
        return " ".join(text.replace(_WS, " ").split())

    @property
    def vocab_size(self) -> int:
        return len(self._pieces)

    @property
    def blank_id(self) -> int:
        return self.BLANK

    def id_to_piece(self, i: int) -> str:
        return self._pieces[i]

    # ------------------------------------------------------------------ #
    def to_dict(self) -> dict:
        return {
            "type": "unigram",
            "pieces": self._pieces[2:],
            "scores": self._scores[2:],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "UnigramTokenizer":
        return cls(d["pieces"], d["scores"])

    def save(self, path: str):
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, ensure_ascii=False)
