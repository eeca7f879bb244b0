"""The train step: frontend → encoder(state) → CTC or RNN-T loss → update.

Port of ``statecatcher_tpu/train/step.py`` (``_make_step_body``,
``make_train_step``, ``make_segment_scan_step``, ``init_train_state``,
``resolve_rnnt_band``).  One segment's step:

  * int16 audio is de-quantised on the device (÷ 32767.0); a (B,) sample
    mask is a prefix length (``frame_mask_from_lens``), a (B, S) one is
    pooled (``compute_frame_mask``); frame lengths are at least 1;
  * the carry (any encoder's dict of tensors) is detached on entry
    (truncated BPTT across segments);
  * CTC: loss = the ``row_valid``-masked mean of the per-row CTC loss; the
    per-utterance totals (per-row loss × max(tok_len, 1)) go out for the
    hallucination filter;
  * RNN-T (``train.mode="rnnt"``): the joiner projects the encoder output
    and the blank-prefixed tokens; loss = the ``row_valid``-masked mean of
    the per-utterance transducer NLL, which goes to the filter as it is
    (``resolve_rnnt_impl`` picks the loss);
  * on CUDA the LucyRNN cells run K1 forward and K2 backward (K5 with a
    frame mask or ``kernel_impl="pallas"``), the xLSTM's mLSTM layers K9a
    forward and K9b backward (K10 forward with ``xlstm.kernel_impl=
    "pallas"``), the CTC lattice K3 and K4 (with
    ``ctc_impl`` "auto" or "pallas"), and the transducer (``rnnt_impl``
    "auto" or "pallas") the joint K6 and its lattice K7, or with a band > 0
    (``train.rnnt_band``, -1: band 32 above a padded U of 48) the banded
    joint K8 and the banded lattice, with ``train.rnnt_time_block`` frames
    per band block;
  * ``ok`` = finite loss and grad norm (and loss < ``skip_loss_above``) is
    decided on the device: a bad segment leaves the parameters, the
    optimizer state and the carry as they were, through ``torch.where``,
    with no host sync;
  * greedy preds and keep-mask (CTC greedy of the encoder output, in both
    modes, as the JAX package) are computed on the device.

Unlike JAX's pure functions, the step updates the model's parameters and the
optimizer state in place (``TrainState``), which saves a copy of each.

``make_segment_scan_step`` runs the K segments of a group in a loop with the
carry threaded through; ``seg_valid`` (a host array: the loop builds it)
skips padded segments, and the outputs are stacked over K.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from statecatcher_tpu_torch.config import Config
from statecatcher_tpu_torch.decode import ctc_greedy_decode
from statecatcher_tpu_torch.frontend import (
    compute_features,
    compute_frame_mask,
    frame_mask_from_lens,
    num_frames,
)
from statecatcher_tpu_torch.models.rnnt import make_prefix
from statecatcher_tpu_torch.ops.ctc import ctc_loss_per_example
from statecatcher_tpu_torch.ops.rnnt import rnnt_loss_fused
from statecatcher_tpu_torch.ops.rnnt_band import rnnt_loss_banded
from statecatcher_tpu_torch.ops.rnnt_joint import rnnt_loss_pallas
from statecatcher_tpu_torch.train.optim import (
    build_optimizer,
    global_norm,
    lr_schedule,
    tree_map,
    tree_where,
)

__all__ = ["StepOutput", "TrainState", "build_optimizer", "init_train_state", "lr_schedule",
           "make_segment_scan_step", "make_train_step", "resolve_rnnt_band",
           "resolve_rnnt_impl"]


class StepOutput(NamedTuple):
    loss: torch.Tensor          # scalar
    grad_norm: torch.Tensor     # scalar (pre-clip global norm)
    preds: torch.Tensor         # (B, T) greedy argmax tokens
    keep: torch.Tensor          # (B, T) greedy keep-mask
    in_lens: torch.Tensor       # (B,)
    per_loss: torch.Tensor      # (B,) per-utterance loss (hallucination filter)


class TrainState:
    """The model's parameters (updated in place), the optimizer and its
    state, and the update count ``step``."""

    def __init__(self, model: torch.nn.Module, tx):
        self.model = model
        self.tx = tx
        self.params = dict(model.named_parameters())
        self.opt_state = tx.init({k: p.detach() for k, p in self.params.items()})
        self.step = torch.zeros((), dtype=torch.int32, device=next(iter(self.params.values())).device)

    @torch.no_grad()
    def apply_gradients(self, grads: dict, ok: Optional[torch.Tensor] = None) -> None:
        """One optimizer update; with ``ok`` (a device bool) every change is
        kept only where ``ok`` is true."""
        params = {k: p.detach() for k, p in self.params.items()}
        updates, new_opt = self.tx.update(grads, self.opt_state, params)
        if ok is None:
            ok = torch.ones((), dtype=torch.bool, device=self.step.device)
        for k, p in params.items():
            p.copy_(torch.where(ok, (p + updates[k]).to(p.dtype), p))
        self.opt_state = tree_where(ok, new_opt, self.opt_state)
        self.step = torch.where(ok, self.step + 1, self.step)

    def state_dict(self) -> dict:
        """Parameters, optimizer state and step: copies on the CPU."""
        cpu = lambda t: t.detach().to("cpu", copy=True)
        return {"params": {k: cpu(p) for k, p in self.params.items()},
                "opt_state": tree_map(cpu, self.opt_state), "step": cpu(self.step)}

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        dev = self.step.device
        for k, p in self.params.items():
            p.copy_(sd["params"][k])
        self.opt_state = tree_map(lambda t: t.to(dev), sd["opt_state"])
        self.step = sd["step"].to(dev)


def init_train_state(model: torch.nn.Module, cfg: Config) -> TrainState:
    """The optimizer of ``cfg.train.optim`` over ``model``'s parameters (the
    model's own initialisation stands for the JAX package's dummy forward;
    in RNN-T mode the joiner's parameters are among them)."""
    _check_mode(cfg)
    return TrainState(model, build_optimizer(cfg.train.optim))


def _check_mode(cfg: Config) -> None:
    if cfg.train.mode not in ("ctc", "rnnt"):
        raise ValueError(f"train.mode must be 'ctc' or 'rnnt', got {cfg.train.mode!r}")


def resolve_rnnt_band(requested: int, u_pad: int) -> int:
    """Band width of the transducer loss at a padded label length: a
    ``requested`` width ≥ 0 as it is (0 = exact); -1 (auto) is exact for
    u_pad ≤ 48 and 32 above (the JAX package's measured crossover; the loop
    buckets U to multiples of 16)."""
    if requested >= 0:
        return requested
    return 32 if u_pad > 48 else 0


def resolve_rnnt_impl(impl: str, on_cuda: bool) -> str:
    """The transducer loss a step runs: "pallas" (the kernels: K6 + K7, or
    with a band > 0 the banded K8 + its lattice; their plain versions on the
    CPU) or "xla" (``rnnt_loss_fused``, autograd).  "auto" is "pallas" on
    the card and "xla" on the CPU, where the JAX package resolves "auto" to
    "xla" too and so ignores the band."""
    if impl == "auto":
        impl = "pallas" if on_cuda else "xla"
    if impl not in ("pallas", "xla"):
        raise ValueError(f"Unknown RNN-T impl {impl!r}")
    return impl


def _no_mesh(mesh_plan) -> None:
    if mesh_plan is not None:
        raise NotImplementedError(
            "mesh plans (data, tensor and sequence parallelism) are not ported yet "
            "(parallel/mesh.py, parallel/distributed.py: multi-GPU in ROADMAP.md)")


def _pred_shape(audio: torch.Tensor, cfg: Config) -> tuple[int, int]:
    T = num_frames(int(audio.shape[-1]), cfg.frontend)
    s = max(1, cfg.model.stack_order)
    if s > 1:
        T = T // s
    return (audio.shape[0], T)


def _make_step_body(model, cfg: Config, blank_id: int, ctc_impl: str):
    """The single-segment step body shared by both step makers."""
    _check_mode(cfg)
    rnnt = cfg.train.mode == "rnnt"
    fe = cfg.frontend
    stack_order = max(1, cfg.model.stack_order)
    skip_above = cfg.train.skip_loss_above
    gate_ok = cfg.train.skip_nonfinite_updates or skip_above is not None

    def step(state: TrainState, carry, audio, sample_mask, tokens, tok_lens, row_valid):
        S = audio.shape[-1]
        if audio.dtype == torch.int16:
            audio = audio.to(torch.float32) / 32767.0
        with torch.no_grad():
            feats = compute_features(audio, fe)
        T = feats.shape[1]
        if sample_mask.ndim == 1:
            frame_mask, in_lens = frame_mask_from_lens(sample_mask, S, T, stack_order)
        else:
            frame_mask, in_lens = compute_frame_mask(sample_mask, T, stack_order)
        in_lens = torch.clamp(in_lens, min=1)
        carry_in = {k: v.detach() for k, v in carry.items()}

        for p in state.params.values():
            p.grad = None
        if rnnt:
            band = resolve_rnnt_band(cfg.train.rnnt_band, tokens.shape[-1])
            impl = resolve_rnnt_impl(cfg.train.rnnt_impl, feats.is_cuda)
            logits, new_state, proj = state.model(feats, carry_in, frame_mask,
                                                  make_prefix(tokens, blank_id))
            if impl == "pallas" and band > 0:
                loss, per = rnnt_loss_banded(*proj, tokens, in_lens, tok_lens, blank_id=blank_id,
                                             row_valid=row_valid,
                                             time_block=cfg.train.rnnt_time_block, band=band,
                                             return_per=True)
            elif impl == "pallas":
                loss, per = rnnt_loss_pallas(*proj, tokens, in_lens, tok_lens, blank_id=blank_id,
                                             row_valid=row_valid, return_per=True)
            else:
                loss, per = rnnt_loss_fused(*proj, tokens, in_lens, tok_lens, blank_id=blank_id,
                                            row_valid=row_valid,
                                            time_chunk=cfg.train.rnnt_time_chunk,
                                            return_per=True)
        else:
            logits, new_state = state.model(feats, carry_in, frame_mask)
            per = ctc_loss_per_example(logits, in_lens, tokens, tok_lens, blank_id=blank_id,
                                       impl=ctc_impl)
            valid = row_valid.to(per.dtype)
            loss = (per * valid).sum() / torch.clamp(valid.sum(), min=1.0)
            # the hallucination filter wants the TOTAL per-utterance NLL (the
            # transducer's per-row NLL already is one)
            per = per * torch.clamp(tok_lens, min=1).to(per.dtype)
        loss.backward()
        per_loss = per.detach().to(torch.float32)
        grads = {k: (torch.zeros_like(p) if p.grad is None else p.grad)
                 for k, p in state.params.items()}
        grad_norm = global_norm(grads)

        loss = loss.detach()
        if gate_ok:
            ok = torch.isfinite(loss) & torch.isfinite(grad_norm)
            if skip_above is not None:
                ok = ok & (loss < skip_above)
        else:
            ok = torch.ones((), dtype=torch.bool, device=loss.device)
        state.apply_gradients(grads, ok)
        for p in state.params.values():
            p.grad = None
        new_carry = tree_where(ok, {k: v.detach() for k, v in new_state.items()}, carry_in)

        preds, keep = ctc_greedy_decode(logits.detach(), in_lens, blank_id)
        out = StepOutput(loss=loss, grad_norm=grad_norm, preds=preds, keep=keep,
                         in_lens=in_lens, per_loss=per_loss)
        return state, new_carry, out

    return step


def make_train_step(model, cfg: Config, blank_id: int = 0, mesh_plan=None,
                    ctc_impl: str = "lattice"):
    """``(state, carry, audio, sample_mask, tokens, tok_lens, row_valid) →
    (state, carry, StepOutput)`` for one segment."""
    _no_mesh(mesh_plan)
    return _make_step_body(model, cfg, blank_id, ctc_impl)


def make_segment_scan_step(model, cfg: Config, blank_id: int = 0, mesh_plan=None,
                           ctc_impl: str = "lattice"):
    """Whole-group step over K segment slices, the carry threaded through.

    Shapes: audio (K, B, S), sample_mask (K, B, S) or (K, B) prefix lengths,
    tokens (K, B, U), tok_lens (K, B), row_valid (K, B); ``seg_valid`` (K,)
    is a host bool array (a tensor is brought to the host): a False segment
    leaves state and carry untouched and outputs zeros.  Returns
    (state, carry, StepOutput with every field stacked over K)."""
    _no_mesh(mesh_plan)
    base_step = _make_step_body(model, cfg, blank_id, ctc_impl)

    def batch_step(state, carry, audio, sample_mask, tokens, tok_lens, row_valid, seg_valid):
        if isinstance(seg_valid, torch.Tensor):
            seg_valid = seg_valid.cpu().numpy()
        seg_valid = np.asarray(seg_valid, bool)
        outs = []
        for k in range(audio.shape[0]):
            a = audio[k]
            if seg_valid[k]:
                state, carry, out = base_step(state, carry, a, sample_mask[k], tokens[k],
                                              tok_lens[k], row_valid[k])
            else:
                dev, shape = a.device, _pred_shape(a, cfg)
                zero = torch.zeros((), dtype=torch.float32, device=dev)
                out = StepOutput(
                    loss=zero, grad_norm=zero,
                    preds=torch.zeros(shape, dtype=torch.int32, device=dev),
                    keep=torch.zeros(shape, dtype=torch.bool, device=dev),
                    in_lens=torch.zeros((a.shape[0],), dtype=torch.int32, device=dev),
                    per_loss=torch.zeros((a.shape[0],), dtype=torch.float32, device=dev))
            outs.append(out)
        ref = next((o for o, v in zip(outs, seg_valid) if v), outs[0])
        stacked = StepOutput(*(torch.stack([o[i].to(ref[i].dtype) for o in outs])
                               for i in range(len(StepOutput._fields))))
        return state, carry, stacked

    return batch_step
