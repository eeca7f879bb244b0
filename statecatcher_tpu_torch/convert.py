"""Weight bridge: flax params tree ⇄ PyTorch state_dict.

Covers the trees of ``ASRModel`` and ``SpeechModel`` (the ASR module under
``asr``, the RNN-T joiner under ``joiner``) for the LSTM, LucyRNN (7-gate
and native) and xLSTM encoders.  Dense and GateProj kernels are (in, out) in
flax and (out, in) here, so they are transposed; the LSTM's ``w_ih`` (Din,
4H), ``w_hh`` (H, 4H) and its two biases keep the flax layout on both sides
(the port computes ``x @ w_ih`` as JAX does), so they are copied as they
are, and its ``classifier`` is a Dense; a LayerNorm's or
RMSNorm's ``scale`` is its ``weight``; an Embed's ``embedding`` is its
``weight``; ``join_kernel`` stays (J, V).  The flax side is plain numpy
(``np.asarray`` of each leaf), so this module needs no JAX.  Both
directions copy values exactly: flax → torch → flax is bit-identical.
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

    def dense(fpath, tkey, bias=True):
        out.append((fpath + ("kernel",), f"{tkey}.weight", True))
        if bias:
            out.append((fpath + ("bias",), f"{tkey}.bias", False))

    if cfg.input_proj_dim > 0:
        dense(("proj",), "proj")
    if cfg.encoder == "lstm":
        for l in range(cfg.num_layers):
            for name in ("w_ih", "w_hh", "b_ih", "b_hh"):
                out.append((("encoder", f"layer{l}", name), f"encoder.layer{l}.{name}", False))
        dense(("classifier",), "classifier")
        return out
    if cfg.encoder == "xlstm":
        _xlstm_mapping(cfg, dense, out)
        return out
    if cfg.lucyrnn.variant == "native":
        _native_mapping(cfg, dense, out)
        return out
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


def _xlstm_mapping(cfg: ModelConfig, dense, out: list) -> None:
    """Append the xLSTM encoder's leaves to ``out`` (``dense`` appends there)."""
    def norm(name):
        out.append((("encoder", name, "scale"), f"encoder.{name}.weight", False))

    dense(("encoder", "input_proj"), "encoder.input_proj")
    for bi in range(cfg.xlstm.num_blocks):
        norm(f"block{bi}_norm_mlstm")
        mp, mk = ("encoder", f"block{bi}_mlstm"), f"encoder.block{bi}_mlstm"
        for name in ("q", "k", "v"):
            dense(mp + (name,), f"{mk}.{name}", bias=False)
        for name in ("igate", "fgate"):
            dense(mp + (name,), f"{mk}.{name}")
        out.append((mp + ("head_norm", "scale"), f"{mk}.head_norm.weight", False))
        for name in ("ogate", "out_proj"):
            dense(mp + (name,), f"{mk}.{name}", bias=False)
        norm(f"block{bi}_norm_ffn")
        for name in ("gate", "up", "down"):
            dense(("encoder", f"block{bi}_ffn", name), f"encoder.block{bi}_ffn.{name}",
                  bias=False)
    norm("final_norm")
    dense(("encoder", "vocab_proj"), "encoder.vocab_proj")


def _native_mapping(cfg: ModelConfig, dense, out: list) -> None:
    """Append the native LucyRNN encoder's leaves to ``out``: per layer the
    input projection, ``W_fused`` (``fused_ops``) or ``W_r`` … ``W_h``, and
    with ``layer_norm`` four LayerNorms; then the output projection."""
    lc = cfg.lucyrnn
    for l in range(cfg.num_layers):
        fp, tk = ("encoder", f"layer{l}"), f"encoder.layer{l}"
        names = ["W_fused"] if lc.fused_ops else ["W_r", "W_z", "W_k", "W_v", "W_decay", "W_h"]
        for name in ["input_proj"] + names:
            dense(fp + (name,), f"{tk}.{name}")
        if lc.layer_norm:
            for name in ("layernorm_in", "layernorm_r", "layernorm_z", "layernorm_h"):
                out.append((fp + (name, "scale"), f"{tk}.{name}.weight", False))
                out.append((fp + (name, "bias"), f"{tk}.{name}.bias", False))
    dense(("encoder", "output_proj"), "encoder.output_proj")


# The RNN-T joiner's leaves, relative to the top of a SpeechModel tree.
# join_kernel keeps the JAX layout (J, V) on both sides.
_JOINER = [
    (("joiner", "embedding", "embedding"), "joiner.embedding.weight", False),
    (("joiner", "enc_proj", "kernel"), "joiner.enc_proj.weight", True),
    (("joiner", "enc_proj", "bias"), "joiner.enc_proj.bias", False),
    (("joiner", "pred_proj", "kernel"), "joiner.pred_proj.weight", True),
    (("joiner", "pred_proj", "bias"), "joiner.pred_proj.bias", False),
    (("joiner", "join_kernel"), "joiner.join_kernel", False),
    (("joiner", "join_bias"), "joiner.join_bias", False),
]


def _count_leaves(tree) -> int:
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return sum(_count_leaves(v) for _, v in tree.items())
    return 1


def _full_mapping(cfg: ModelConfig, speech: bool, rnnt: bool):
    """The mapping of a whole tree: an ASRModel's (``speech`` False), or a
    SpeechModel's with its leaves under ``asr`` (and ``joiner`` for RNN-T)."""
    if not speech:
        return _mapping(cfg)
    out = [(("asr",) + path, "asr." + key, tr) for path, key, tr in _mapping(cfg)]
    return out + (_JOINER if rnnt else [])


def flax_to_torch(params: Any, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """flax params (``{"params": ...}`` or the inner tree, of an ASRModel or
    a SpeechModel in either mode) → state_dict of CPU tensors for the port's
    model."""
    tree = params["params"] if "params" in params else params
    mapping = _full_mapping(cfg, "asr" in tree, "joiner" in tree)
    if _count_leaves(tree) != len(mapping):
        raise ValueError(f"flax tree has {_count_leaves(tree)} leaves, config "
                         f"{cfg} expects {len(mapping)}")
    sd = {}
    for path, key, transposed in mapping:
        node = tree
        for p in path:
            node = node[p]
        arr = np.asarray(node)
        sd[key] = torch.from_numpy(np.ascontiguousarray(arr.T if transposed else arr))
    return sd


def torch_to_flax(state_dict: dict[str, torch.Tensor], cfg: ModelConfig) -> dict:
    """state_dict of an ASRModel or SpeechModel (either mode) →
    ``{"params": tree}`` of numpy arrays in the flax layout."""
    mapping = _full_mapping(cfg, any(k.startswith("asr.") for k in state_dict),
                            any(k.startswith("joiner.") for k in state_dict))
    if len(state_dict) != len(mapping):
        raise ValueError(f"state_dict has {len(state_dict)} entries, config "
                         f"{cfg} expects {len(mapping)}")
    tree: dict = {}
    for path, key, transposed in mapping:
        arr = state_dict[key].detach().cpu().numpy()
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.array(arr.T if transposed else arr, order="C")   # a copy, not a view
    return {"params": tree}
