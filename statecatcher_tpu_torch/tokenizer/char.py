"""Character-level tokenizer: id 0 = blank, id 1 = unk, id 2 = space, rest chars."""

from __future__ import annotations

import json
from collections import Counter


class CharTokenizer:
    BLANK = 0
    UNK = 1

    def __init__(self, chars: list[str]):
        # chars excludes the specials; stable, sorted storage
        self._chars = list(chars)
        self._id_of = {c: i + 2 for i, c in enumerate(self._chars)}
        self._pieces = ["<blk>", "<unk>"] + self._chars

    # ------------------------------------------------------------------ #
    @classmethod
    def train(cls, corpus: list[str], max_vocab: int | None = None) -> "CharTokenizer":
        counts = Counter()
        for line in corpus:
            counts.update(line)
        chars = [c for c, _ in counts.most_common()]
        if max_vocab is not None:
            chars = chars[: max(0, max_vocab - 2)]
        return cls(sorted(chars))

    # ------------------------------------------------------------------ #
    def encode(self, text: str) -> list[int]:
        return [self._id_of.get(c, self.UNK) for c in text]

    def decode_ids(self, ids: list[int]) -> str:
        out = []
        for i in ids:
            if i in (self.BLANK, self.UNK):
                continue
            if 0 <= i < len(self._pieces):
                out.append(self._pieces[i])
        return "".join(out)

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
        return {"type": "char", "chars": self._chars}

    @classmethod
    def from_dict(cls, d: dict) -> "CharTokenizer":
        return cls(d["chars"])

    def save(self, path: str):
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, ensure_ascii=False)
