"""Tokenizers (own copies of the JAX package's): piece 0 is the CTC blank
and is never produced by encode.  Three backends: the sentencepiece adapter
(``spm.py``, when the package is installed), the character tokenizer and
the unigram model (EM-trained, Viterbi encode; ``train_tokenizer.py``
trains it)."""

from statecatcher_tpu_torch.tokenizer.base import Tokenizer, load_tokenizer
from statecatcher_tpu_torch.tokenizer.char import CharTokenizer
from statecatcher_tpu_torch.tokenizer.unigram import UnigramTokenizer

__all__ = ["Tokenizer", "load_tokenizer", "CharTokenizer", "UnigramTokenizer"]
