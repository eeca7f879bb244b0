"""Tokenizer protocol and model-file loading (own copy of
``statecatcher_tpu/tokenizer/base.py``)."""

from __future__ import annotations

import json
from typing import Protocol, runtime_checkable


@runtime_checkable
class Tokenizer(Protocol):
    """Surface the training loop needs (reference train.py:91-97,205,239-240)."""

    def encode(self, text: str) -> list[int]: ...

    def decode_ids(self, ids: list[int]) -> str: ...

    @property
    def vocab_size(self) -> int: ...

    @property
    def blank_id(self) -> int: ...


def load_tokenizer(path: str) -> "Tokenizer":
    """Load a tokenizer model file: ``*.json`` of type "char".

    The JAX package also loads sentencepiece ``*.model`` files and its own
    "unigram" JSON; those tokenizers are not ported yet and raise.
    """
    if path.endswith(".model"):
        raise NotImplementedError(
            "sentencepiece tokenizers are not ported yet (tokenizer/spm.py; ROADMAP.md, "
            "the host side)")
    with open(path) as f:
        blob = json.load(f)
    kind = blob.get("type")
    if kind == "char":
        from statecatcher_tpu_torch.tokenizer.char import CharTokenizer

        return CharTokenizer.from_dict(blob)
    if kind == "unigram":
        raise NotImplementedError(
            "the unigram tokenizer is not ported yet (tokenizer/unigram.py; ROADMAP.md, "
            "the host side)")
    raise ValueError(f"Unknown tokenizer model format in {path}")
