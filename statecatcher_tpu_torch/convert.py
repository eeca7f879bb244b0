"""Weight bridge: flax params tree ⇄ PyTorch state_dict.

Covers the trees of ``ASRModel`` and ``SpeechModel`` (the ASR module under
``asr``) for the LucyRNN encoder.  Dense and GateProj kernels are (in, out)
in flax and (out, in) here, so they are transposed; a LayerNorm's ``scale``
is its ``weight``.  The flax side is plain numpy (``np.asarray`` of each
leaf), so this module needs no JAX.  Both directions copy values exactly:
flax → torch → flax is bit-identical.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from statecatcher_tpu_torch.config import ModelConfig
from statecatcher_tpu_torch.models.asr import check_supported


def _mapping(cfg: ModelConfig) -> list[tuple[tuple[str, ...], str, bool]]:
    """(flax path, torch key, transposed) for every parameter of ``cfg``."""
    check_supported(cfg)
    out = []

    def dense(fpath, tkey):
        out.append((fpath + ("kernel",), f"{tkey}.weight", True))
        out.append((fpath + ("bias",), f"{tkey}.bias", False))

    if cfg.input_proj_dim > 0:
        dense(("proj",), "proj")
    L = cfg.num_layers
    for t in range(cfg.lucyrnn.num_tracks):
        for l in range(L):
            dense(("encoder", f"track{t}_layer{l}", "gate_proj"),
                  f"encoder.track{t}_layer{l}.gate_proj")
            if l < L - 1:
                norm = ("encoder", f"track{t}_norm{l}")
                out.append((norm + ("scale",), f"encoder.track{t}_norm{l}.weight", False))
                out.append((norm + ("bias",), f"encoder.track{t}_norm{l}.bias", False))
    if cfg.lucyrnn.num_tracks > 1:
        dense(("encoder", "merge_proj"), "encoder.merge_proj")
    dense(("encoder", "output_proj"), "encoder.output_proj")
    return out


def _count_leaves(tree) -> int:
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return sum(_count_leaves(v) for _, v in tree.items())
    return 1


def flax_to_torch(params: Any, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """flax params (``{"params": ...}`` or the inner tree, of an ASRModel or
    a SpeechModel) → state_dict of CPU tensors for the port's model."""
    tree = params["params"] if "params" in params else params
    prefix = ""
    if "asr" in tree:
        tree, prefix = tree["asr"], "asr."
    mapping = _mapping(cfg)
    if _count_leaves(tree) != len(mapping):
        raise ValueError(f"flax tree has {_count_leaves(tree)} leaves, config "
                         f"{cfg} expects {len(mapping)}")
    sd = {}
    for path, key, transposed in mapping:
        node = tree
        for p in path:
            node = node[p]
        arr = np.asarray(node)
        sd[prefix + key] = torch.from_numpy(np.ascontiguousarray(arr.T if transposed else arr))
    return sd


def torch_to_flax(state_dict: dict[str, torch.Tensor], cfg: ModelConfig) -> dict:
    """state_dict of an ASRModel or SpeechModel → ``{"params": tree}`` of
    numpy arrays in the flax layout."""
    prefix = "asr." if any(k.startswith("asr.") for k in state_dict) else ""
    mapping = _mapping(cfg)
    if len(state_dict) != len(mapping):
        raise ValueError(f"state_dict has {len(state_dict)} entries, config "
                         f"{cfg} expects {len(mapping)}")
    tree: dict = {}
    for path, key, transposed in mapping:
        arr = state_dict[prefix + key].detach().cpu().numpy()
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.array(arr.T if transposed else arr, order="C")   # a copy, not a view
    return {"params": {"asr": tree} if prefix else tree}
