"""The tokenizers of the PyTorch port (statecatcher_tpu_torch/tokenizer:
unigram.py, spm.py, base.py's ``load_tokenizer``) and its tokenizer trainer
(train_tokenizer.py) against the JAX package's.

  * Unigram EM training gives the same pieces, scores and ids; encode and
    decode agree, unknown characters included.
  * ``python -m statecatcher_tpu_torch.train_tokenizer`` writes the same
    JSON as JAX's trainer, from a corpus file, a VTT directory and stdin,
    with the unigram and char backends.
  * ``CharTokenizer`` gives JAX's ids, pieces (``id_to_piece``) and text.
  * ``load_tokenizer`` loads "unigram" JSON, and ``.model`` files through
    the sentencepiece adapter (tested with a stub module: the package is not
    installed; without it a ``.model`` raises ImportError, as in JAX).
"""

import io
import json
import sys
import types

import pytest

from statecatcher_tpu import train_tokenizer as j_train_tokenizer
from statecatcher_tpu.tokenizer import CharTokenizer as JChar
from statecatcher_tpu.tokenizer import UnigramTokenizer as JUnigram
from statecatcher_tpu.tokenizer import load_tokenizer as j_load_tokenizer
from statecatcher_tpu_torch import train_tokenizer
from statecatcher_tpu_torch.tokenizer import CharTokenizer, UnigramTokenizer, load_tokenizer
from statecatcher_tpu_torch.tokenizer.spm import SentencePieceTokenizer

CORPUS = [
    "the quick brown fox jumps over the lazy dog",
    "the lazy dog sleeps all day, doesn't it?",
    "a quick brown cat jumps too 42 times",
    "all the quick animals jump over dogs",
    "Straße über naïve café",
] * 5


@pytest.mark.parametrize("vocab,max_len", [(48, 8), (96, 8), (64, 4)])
def test_unigram_training_matches_jax(vocab, max_len):
    tok = UnigramTokenizer.train(CORPUS, vocab_size=vocab, max_piece_len=max_len)
    jtok = JUnigram.train(CORPUS, vocab_size=vocab, max_piece_len=max_len)
    assert tok.to_dict() == jtok.to_dict()
    assert tok.vocab_size == jtok.vocab_size <= vocab and tok.blank_id == 0
    assert tok.id_to_piece(0) == "<blk>" and tok.id_to_piece(1) == "<unk>"
    for text in ("the quick brown fox", "lazy dogs jump", "café ¤ über", "", "zzz qq"):
        ids = tok.encode(text)
        assert ids == jtok.encode(text) and tok.blank_id not in ids
        assert tok.decode_ids(ids) == jtok.decode_ids(ids)
    assert tok.decode_ids(tok.encode("the quick brown fox")) == "the quick brown fox"


def test_char_tokenizer_matches_jax():
    tok, jtok = CharTokenizer.train(CORPUS), JChar.train(CORPUS)
    assert tok.to_dict() == jtok.to_dict() and tok.vocab_size == jtok.vocab_size
    assert [tok.id_to_piece(i) for i in range(tok.vocab_size)] == \
        [jtok.id_to_piece(i) for i in range(jtok.vocab_size)]
    assert tok.id_to_piece(0) == "<blk>" and tok.id_to_piece(1) == "<unk>"
    for text in ("the quick brown fox", "café ¤ über", ""):
        ids = tok.encode(text)
        assert ids == jtok.encode(text) and tok.decode_ids(ids) == jtok.decode_ids(ids)


def test_unigram_save_and_load(tmp_path):
    tok = UnigramTokenizer.train(CORPUS, vocab_size=64)
    tok.save(str(tmp_path / "uni.json"))
    back = load_tokenizer(str(tmp_path / "uni.json"))
    assert isinstance(back, UnigramTokenizer) and back.to_dict() == tok.to_dict()
    assert j_load_tokenizer(str(tmp_path / "uni.json")).to_dict() == tok.to_dict()
    assert back.encode("quick brown") == tok.encode("quick brown")


def _vtt_dir(root):
    root.mkdir()
    for i, line in enumerate(CORPUS[:5]):
        (root / f"r{i}.vtt").write_text(
            f"WEBVTT\n\n00:00:00.000 --> 00:00:01.500\n{line}\n\n"
            f"00:00:01.500 --> 00:00:03.000\nsegment {i}\n")
    (root / "notes.txt").write_text("not a transcript")
    return str(root)


@pytest.mark.parametrize("source", ["file", "vtt", "stdin"])
@pytest.mark.parametrize("backend,vocab", [("unigram", "48"), ("char", "32")])
def test_train_tokenizer_writes_what_jax_writes(tmp_path, monkeypatch, capsys, source, backend,
                                                vocab):
    if source == "file":
        (tmp_path / "corpus.txt").write_text("\n".join(CORPUS) + "\n\n")
        path = str(tmp_path / "corpus.txt")
    elif source == "vtt":
        path = _vtt_dir(tmp_path / "vtts")
    else:
        path = "-"
    out = {}
    for name, main in (("port", train_tokenizer.main), ("jax", j_train_tokenizer.main)):
        monkeypatch.setattr(sys, "stdin", io.StringIO("\n".join(CORPUS)))
        prefix = str(tmp_path / name)
        assert main(["--input", path, "--model-prefix", prefix, "--vocab-size", vocab,
                     "--backend", backend]) == 0
        assert capsys.readouterr().out.strip() == f"Wrote {prefix}.json"
        out[name] = json.loads(open(prefix + ".json").read())
    assert out["port"] == out["jax"] and out["port"]["type"] == backend
    tok = load_tokenizer(str(tmp_path / "port.json"))
    assert tok.decode_ids(tok.encode("the quick")) == "the quick"


def test_train_tokenizer_refuses_an_empty_corpus(tmp_path, capsys):
    (tmp_path / "empty.txt").write_text("\n  \n")
    assert train_tokenizer.main(["--input", str(tmp_path / "empty.txt"), "--model-prefix",
                                 str(tmp_path / "t")]) == 1
    assert "Empty corpus" in capsys.readouterr().err


class _Processor:
    """A stand-in for ``sentencepiece.SentencePieceProcessor``."""

    def load(self, path):
        self.path = path

    def encode(self, text, out_type=int):
        return [3 + ord(c) % 5 for c in text if c != " "]

    def decode_ids(self, ids):
        return "|".join(map(str, ids))

    def get_piece_size(self):
        return 1024

    def id_to_piece(self, i):
        return f"p{i}"


def test_sentencepiece_adapter_through_a_stub(tmp_path, monkeypatch):
    trained = {}
    stub = types.SimpleNamespace(
        SentencePieceProcessor=_Processor,
        SentencePieceTrainer=types.SimpleNamespace(Train=lambda **kw: trained.update(kw)))
    monkeypatch.setitem(sys.modules, "sentencepiece", stub)
    tok = load_tokenizer(str(tmp_path / "x.model"))
    assert isinstance(tok, SentencePieceTokenizer) and tok._sp.path == str(tmp_path / "x.model")
    assert tok.vocab_size == 1024 and tok.blank_id == 0 and tok.id_to_piece(7) == "p7"
    assert tok.encode("ab c") == [5, 6, 7] and tok.decode_ids([5, 6]) == "5|6"
    # --backend spm hands the corpus to sentencepiece's trainer as JAX's does
    (tmp_path / "c.txt").write_text("hello world\n")
    prefix = str(tmp_path / "sp")
    assert train_tokenizer.main(["--input", str(tmp_path / "c.txt"), "--model-prefix", prefix,
                                 "--backend", "spm", "--vocab-size", "64"]) == 0
    assert trained["model_prefix"] == prefix and trained["vocab_size"] == 64
    assert trained["model_type"] == "unigram" and trained["character_coverage"] == 0.9995
    assert trained["user_defined_symbols"] == j_train_tokenizer.DEFAULT_USER_SYMBOLS
    assert open(prefix + ".corpus.txt").read() == "hello world"


def test_sentencepiece_model_without_the_package_raises(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "sentencepiece", None)     # import fails
    with pytest.raises(ImportError):
        load_tokenizer(str(tmp_path / "x.model"))
    with pytest.raises(ImportError):
        j_load_tokenizer(str(tmp_path / "x.model"))
