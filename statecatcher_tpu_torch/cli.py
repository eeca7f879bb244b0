"""CLI entry: ``python -m statecatcher_tpu_torch.cli [--config file.json]
[--device cuda|cpu] [--a.b v ...]``.

The same dotted config overrides as the JAX package's CLI, e.g.::

    python -m statecatcher_tpu_torch.cli \
        --model.encoder lucyrnn --data.source local --data.local_dir fixtures/ \
        --data.target_duration 16 --train.steps 1000

``--device`` (default ``cuda``) picks where the model trains; ``--device
cpu`` runs the plain PyTorch versions of the kernels.
"""

from __future__ import annotations

import sys

from statecatcher_tpu_torch.config import Config


def _pop(argv: list[str], flag: str):
    if flag not in argv:
        return None
    i = argv.index(flag)
    if i + 1 >= len(argv):
        raise ValueError(f"Missing value for {flag!r}")
    value = argv[i + 1]
    del argv[i:i + 2]
    return value


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    cfg = Config()
    path = _pop(argv, "--config")
    if path is not None:
        with open(path) as f:
            cfg = Config.from_json(f.read())
    device = _pop(argv, "--device") or "cuda"
    cfg = cfg.apply_overrides(argv)

    from statecatcher_tpu_torch.train.loop import train

    summary = train(cfg, device=device)
    print(summary)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
