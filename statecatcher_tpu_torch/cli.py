"""CLI entry: ``python -m statecatcher_tpu_torch.cli [--config file.json]
[--device cuda|cpu] [--a.b v ...]``.

The same dotted config overrides as the JAX package's CLI, e.g.::

    python -m statecatcher_tpu_torch.cli \
        --model.encoder lucyrnn --data.source local --data.local_dir fixtures/ \
        --data.target_duration 16 --train.steps 1000

``--device`` (default ``cuda``) picks where the model trains; ``--device
cpu`` runs the plain PyTorch versions of the kernels.

Multi-GPU: launched by ``torchrun --nproc_per_node N`` (or with its
environment: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``), each process joins the process group and trains on
``cuda:LOCAL_RANK`` (an indexed ``--device`` such as ``cuda:0`` is kept:
ranks that share a card) over ``--backend`` (default ``nccl`` on the card,
``gloo`` on the CPU)::

    torchrun --nproc_per_node 2 -m statecatcher_tpu_torch.cli --mesh.data_parallel 2 ...

``--mesh.model_parallel 2`` splits the LucyRNN's gate columns, or the
xLSTM's heads and FFN columns, over pairs of ranks (the LSTM and the RWKV
run whole on each), and with ``--model.lucyrnn.kernel_impl sp`` the
LucyRNN's scans' time axis.  The xLSTM's FFN width must divide too: at
``--model.xlstm.embedding_dim 512`` the default ``ffn_proj_factor`` 2.667
gives 1365 columns, 2.666 gives 1364.
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
    backend = _pop(argv, "--backend")
    cfg = cfg.apply_overrides(argv)

    from statecatcher_tpu_torch.parallel.distributed import (
        initialize_distributed,
        shutdown_distributed,
    )
    from statecatcher_tpu_torch.train.loop import train

    topo = initialize_distributed(backend, device)
    try:
        summary = train(cfg, device=topo.device)
    finally:
        shutdown_distributed()
    print(summary)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
