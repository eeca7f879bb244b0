"""SentencePiece adapter (only used when the sentencepiece package exists).

Own copy of ``statecatcher_tpu/tokenizer/spm.py``.  With the same ``.model``
file as the reference this produces identical token streams (reference
train.py:91-97: vocab from the processor, blank_id = 0 in sp's <unk> slot).
The package is imported when the tokenizer is made; where it is not
installed, loading a ``.model`` file raises ``ImportError``.
"""

from __future__ import annotations


class SentencePieceTokenizer:
    def __init__(self, model_path: str):
        import sentencepiece as spm  # gated: an optional package

        self._sp = spm.SentencePieceProcessor()
        self._sp.load(model_path)

    def encode(self, text: str) -> list[int]:
        return self._sp.encode(text, out_type=int)

    def decode_ids(self, ids: list[int]) -> str:
        return self._sp.decode_ids(ids)

    @property
    def vocab_size(self) -> int:
        return self._sp.get_piece_size()

    @property
    def blank_id(self) -> int:
        return 0  # reference train.py:96 contract

    def id_to_piece(self, i: int) -> str:
        return self._sp.id_to_piece(i)
