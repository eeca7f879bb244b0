"""``python -m statecatcher_tpu_torch`` → the training CLI (see cli.py)."""

from statecatcher_tpu_torch.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
