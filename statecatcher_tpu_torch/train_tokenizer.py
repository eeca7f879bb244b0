"""Tokenizer trainer CLI — replacement for reference train_sentencepiece.py.

Own copy of ``statecatcher_tpu/train_tokenizer.py``, with the same surface
and defaults.

Trains our unigram (or char) tokenizer from a text corpus file, a directory
of VTTs, or stdin.  Defaults mirror the reference trainer surface
(vocab 1024, digits+punctuation kept as user symbols; reference
train_sentencepiece.py:31-72).  When the sentencepiece package is available,
``--backend spm`` delegates to it for byte-identical parity with reference
models (the package is optional: the port does not depend on it).

Usage::

    python -m statecatcher_tpu_torch.train_tokenizer --input corpus.txt \
        --model-prefix my_tokenizer --vocab-size 1024 [--backend unigram|char|spm]
"""

from __future__ import annotations

import argparse
import os
import sys


def _load_corpus(path: str) -> list[str]:
    if os.path.isdir(path):
        from statecatcher_tpu_torch.data.vtt import vtt_to_segments_with_text

        corpus = []
        for name in sorted(os.listdir(path)):
            if name.endswith(".vtt"):
                with open(os.path.join(path, name)) as f:
                    corpus += [t for _, _, t in vtt_to_segments_with_text(f.read())]
        return corpus
    if path == "-":
        return [line.strip() for line in sys.stdin if line.strip()]
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


DEFAULT_USER_SYMBOLS = list("0123456789") + list(".,?!;:-'\"()")


def main(argv=None):
    p = argparse.ArgumentParser(description="Train a tokenizer")
    p.add_argument("--input", required=True,
                   help="corpus file, dir of .vtt files, or '-' for stdin")
    p.add_argument("--model-prefix", default="tokenizer")
    p.add_argument("--vocab-size", type=int, default=1024)
    p.add_argument("--backend", choices=["unigram", "char", "spm"], default="unigram")
    p.add_argument("--max-piece-len", type=int, default=8)
    p.add_argument("--character-coverage", type=float, default=0.9995,
                   help="spm backend only")
    args = p.parse_args(argv)

    corpus = _load_corpus(args.input)
    if not corpus:
        print("Empty corpus", file=sys.stderr)
        return 1

    if args.backend == "spm":
        import sentencepiece as spm  # gated: an optional package

        corpus_path = args.model_prefix + ".corpus.txt"
        with open(corpus_path, "w") as f:
            f.write("\n".join(corpus))
        # reference train_sentencepiece.py:31-72 surface
        spm.SentencePieceTrainer.Train(
            input=corpus_path, model_prefix=args.model_prefix,
            vocab_size=args.vocab_size, model_type="unigram",
            character_coverage=args.character_coverage,
            user_defined_symbols=DEFAULT_USER_SYMBOLS,
        )
        out = args.model_prefix + ".model"
    elif args.backend == "char":
        from statecatcher_tpu_torch.tokenizer import CharTokenizer

        tok = CharTokenizer.train(corpus, max_vocab=args.vocab_size)
        out = args.model_prefix + ".json"
        tok.save(out)
    else:
        from statecatcher_tpu_torch.tokenizer import UnigramTokenizer

        tok = UnigramTokenizer.train(
            corpus, vocab_size=args.vocab_size, max_piece_len=args.max_piece_len,
        )
        out = args.model_prefix + ".json"
        tok.save(out)
    print(f"Wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
