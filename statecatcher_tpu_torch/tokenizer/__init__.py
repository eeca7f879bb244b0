"""Tokenizers (own copies of the JAX package's): piece 0 is the CTC blank
and is never produced by encode.  The character tokenizer is ported; the
sentencepiece adapter and the unigram model are not yet (``load_tokenizer``
raises for them)."""

from statecatcher_tpu_torch.tokenizer.base import Tokenizer, load_tokenizer
from statecatcher_tpu_torch.tokenizer.char import CharTokenizer

__all__ = ["Tokenizer", "load_tokenizer", "CharTokenizer"]
