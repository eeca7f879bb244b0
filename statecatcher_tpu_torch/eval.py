"""Evaluation harness: WER/CER of a trained model over a dataset.

Port of ``statecatcher_tpu/eval.py``.  A checkpoint is evaluated on the
dataset with the same segment streaming and carried encoder state as
training, decoding with greedy CTC, CTC prefix beam, or (in RNN-T mode)
greedy or beam transducer search; the decode state is carried across a
recording's segments too, with the agreed prefix committed to the host
after each segment (reserve 256 of buffers of 512).  Forward only, under
``torch.inference_mode()``; on the card the LucyRNN's cell runs K1.

Usage::

    python -m statecatcher_tpu_torch.eval --ckpt <run_dir> \\
        [--decoder greedy|beam|rnnt-greedy|rnnt-beam] [--max-batches N] \\
        [--device cuda|cpu] <the training run's config overrides>

``<run_dir>`` is a directory the port's CLI wrote (its ``tokenizer.json``
and newest checkpoint are read).  RNN-T decoders need ``--train.mode rnnt``.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from dataclasses import dataclass

import numpy as np
import torch

from statecatcher_tpu_torch import resolve_device
from statecatcher_tpu_torch.beam import beam_commit, beam_hypotheses, ctc_beam_search
from statecatcher_tpu_torch.config import Config
from statecatcher_tpu_torch.data.pipeline import BatchPipeline, stack_segment_slice
from statecatcher_tpu_torch.decode import (
    boundary_trimmed_lens,
    ctc_greedy_decode,
    dedup_reference_text,
    keep_to_token_lists,
)
from statecatcher_tpu_torch.frontend import compute_features, compute_frame_mask
from statecatcher_tpu_torch.frontend import feat_dim as frontend_feat_dim
from statecatcher_tpu_torch.metrics import cer, wer
from statecatcher_tpu_torch.models.asr import init_carry
from statecatcher_tpu_torch.models.speech import build_speech_model
from statecatcher_tpu_torch.rnnt_decode import (
    rnnt_beam_commit,
    rnnt_beam_search,
    rnnt_beam_to_lists,
    rnnt_drain,
    rnnt_greedy_decode,
    rnnt_state_to_lists,
)

DECODE_BUFFER = 512           # device slots of a decode state's token buffers
COMMIT_RESERVE = 256          # slots a commit keeps free


@dataclass
class EvalResult:
    wer: float
    cer: float
    num_utterances: int
    num_segments: int
    refs: list
    hyps: list


def evaluate(cfg: Config, params: dict, tokenizer, dataset=None, max_batches: int = 10,
             decoder: str = "greedy", beam: int = 8, boundary_dedup: bool = True,
             device="cuda") -> EvalResult:
    """Segment-streaming evaluation with carried encoder state.

    ``params`` is a state_dict of the port's SpeechModel of ``cfg``'s
    ``train.mode`` (vocab from ``tokenizer``).  Hypotheses are accumulated
    per recording across its segments.  ``boundary_dedup`` (default on)
    removes the fixed-size chunker's duplicated boundary cue at the decode
    layer: the stateful RNN-T decoders stop at the next chunk's start
    (``boundary_trimmed_lens``, margin 0), the CTC decoders decode each
    segment in full but force blank on the frames that re-cover audio the
    previous segment decoded, and the duplicated cue's text counts once in
    the joined reference (``dedup_reference_text``).
    """
    from statecatcher_tpu_torch.train.loop import build_dataset

    dev = resolve_device(device)
    mode = cfg.train.mode
    model_cfg = dataclasses.replace(cfg.model, vocab_size=tokenizer.vocab_size)
    model = build_speech_model(model_cfg, frontend_feat_dim(cfg.frontend), mode, device=dev)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in params.items()})
    model.eval()
    stack_order = max(1, model_cfg.stack_order)
    blank_id = tokenizer.blank_id
    if dataset is None:
        dataset = build_dataset(cfg)
    dataset.start_session(batch_size=cfg.data.batch_size, order=cfg.data.order,
                          min_duration=cfg.data.min_duration, max_duration=cfg.data.max_duration)
    sr = cfg.data.batch_samplerate
    target_samples = int(sr * cfg.data.target_duration)
    use_rnnt_dec = mode == "rnnt" and decoder in ("rnnt-greedy", "rnnt-beam")
    fps = sr / float(cfg.frontend.hop_length * stack_order)

    def forward(audio, sample_mask, carry):
        feats = compute_features(audio, cfg.frontend)
        fm, in_lens = compute_frame_mask(sample_mask, feats.shape[1], stack_order)
        logits, new_carry = (model.encode(feats, carry, fm) if mode == "rnnt"
                             else model(feats, carry, fm))
        enc_p = model.rnnt_project_encoder(logits).float() if use_rnnt_dec else None
        return logits.float(), enc_p, in_lens, new_carry

    refs: list[str] = []
    hyps: list[str] = []
    n_segments = 0
    pipe = BatchPipeline(dataset, target_samples, num_workers=cfg.data.num_workers).start()
    try:
        with torch.inference_mode():
            rnnt_tables = (tuple(x.float() for x in model.rnnt_decode_tables())
                           if use_rnnt_dec else None)
            for _ in range(max_batches):
                batch = pipe.get()
                n_rows = len(batch.audio_items)
                K = batch.num_segments(cfg.data.batch_segment_strategy)
                carry = init_carry(model_cfg, n_rows, device=dev)
                per_item_hyp = [[] for _ in range(n_rows)]
                per_item_ref = [[] for _ in range(n_rows)]
                # decode state carried across segments, one hypothesis per
                # recording; tokens committed to the host between segments
                beam_state = totals = rnnt_state = None
                per_item_committed = [[] for _ in range(n_rows)]
                prev_metas = None
                for seg_idx in range(K):
                    audio, mask, texts = stack_segment_slice(batch, seg_idx, target_samples)
                    logits, enc_p, in_lens, carry = forward(
                        torch.from_numpy(audio).to(dev), torch.from_numpy(mask).to(dev), carry)
                    n_segments += 1
                    metas_k = [batch.meta_items[i][seg_idx]
                               if (boundary_dedup and i < len(batch.meta_items)
                                   and seg_idx < len(batch.meta_items[i])) else None
                               for i in range(n_rows)]
                    raw_lens = in_lens
                    # trimmed lengths serve the stateful RNN-T decoders, with
                    # margin 0: a margin would decode frames of the overlap
                    # the next segment decodes again from its frame 0
                    in_lens = torch.from_numpy(boundary_trimmed_lens(
                        in_lens.cpu().numpy(), metas_k, sr, cfg.frontend.hop_length,
                        stack_order, latency_margin_frames=0)).to(dev)
                    if use_rnnt_dec:
                        if decoder == "rnnt-beam":
                            rnnt_state = rnnt_beam_search(
                                enc_p, *rnnt_tables, in_lens, blank_id=blank_id, beam=beam,
                                topk=min(beam, 8), init_state=rnnt_state,
                                max_out=DECODE_BUFFER)
                            rnnt_state, com = rnnt_beam_commit(rnnt_state,
                                                               reserve=COMMIT_RESERVE)
                        else:
                            rnnt_state = rnnt_greedy_decode(
                                enc_p, *rnnt_tables, in_lens, blank_id=blank_id,
                                init_state=rnnt_state, max_out=DECODE_BUFFER)
                            rnnt_state, com = rnnt_drain(rnnt_state)
                        for i in range(n_rows):
                            per_item_committed[i].extend(com[i])
                    elif decoder in ("beam", "greedy"):
                        # stateful CTC: decode the segment in full and force
                        # blank on the frames that re-cover audio the previous
                        # segment decoded, so each instant is decoded once
                        lp = torch.log_softmax(logits, dim=-1)
                        ofs = np.zeros(n_rows, np.int32)
                        for i in range(n_rows):
                            pm = prev_metas[i] if prev_metas else None
                            if pm and pm.get("overlap_start") is not None:
                                ofs[i] = max(0, int((pm["end"] - pm["overlap_start"]) * fps))
                        if ofs.any():
                            frames_ix = torch.arange(lp.shape[1], device=dev)[None, :, None]
                            blank_row = torch.full((lp.shape[-1],), -1e30, dtype=lp.dtype,
                                                   device=dev)
                            blank_row[blank_id] = 0.0
                            lp = torch.where(
                                frames_ix < torch.from_numpy(ofs).to(dev)[:, None, None],
                                blank_row, lp)
                        if decoder == "beam":
                            beam_state, totals = ctc_beam_search(
                                lp, raw_lens, beam=beam, blank_id=blank_id,
                                max_len=DECODE_BUFFER, init_state=beam_state)
                            beam_state, com = beam_commit(beam_state, totals,
                                                          reserve=COMMIT_RESERVE)
                            # forced commits can prune beams: refresh the totals
                            totals = torch.logaddexp(beam_state.p_b, beam_state.p_nb)
                            for i in range(n_rows):
                                per_item_committed[i].extend(com[i])
                        else:
                            batch_hyps = keep_to_token_lists(
                                *ctc_greedy_decode(lp, raw_lens, blank_id))
                            for i in range(n_rows):
                                if seg_idx < len(batch.text_items[i]):
                                    per_item_hyp[i].extend(batch_hyps[i])
                    else:
                        # any other name (an RNN-T decoder in CTC mode): greedy
                        # CTC of the logits within the trimmed lengths
                        batch_hyps = keep_to_token_lists(
                            *ctc_greedy_decode(logits, in_lens, blank_id))
                        for i in range(n_rows):
                            if seg_idx < len(batch.text_items[i]):
                                per_item_hyp[i].extend(batch_hyps[i])
                    for i in range(n_rows):
                        if seg_idx < len(batch.text_items[i]):
                            per_item_ref[i].append(dedup_reference_text(texts[i], metas_k[i]))
                    prev_metas = metas_k
                if use_rnnt_dec:
                    resid = ([h[0][1] if h else [] for h in rnnt_beam_to_lists(rnnt_state)]
                             if decoder == "rnnt-beam" else rnnt_state_to_lists(rnnt_state))
                    per_item_hyp = [per_item_committed[i] + resid[i] for i in range(n_rows)]
                elif decoder == "beam" and beam_state is not None:
                    resid = [h[0][1] if h else [] for h in beam_hypotheses(beam_state, totals)]
                    per_item_hyp = [per_item_committed[i] + resid[i] for i in range(n_rows)]
                for i in range(n_rows):
                    hyps.append(tokenizer.decode_ids(per_item_hyp[i]))
                    refs.append(" ".join(t for t in per_item_ref[i] if t))
                dataset.mark_batch_done(batch.epoch, batch.batch_id)
    finally:
        pipe.stop()
        dataset.end_session()

    return EvalResult(wer=wer(refs, hyps), cer=cer(refs, hyps), num_utterances=len(refs),
                      num_segments=n_segments, refs=refs, hyps=hyps)


def load_run(ckpt_dir: str, cfg: Config, device="cuda"):
    """The tokenizer and the newest checkpoint's parameters of a run
    directory the port's CLI wrote → (cfg with the vocab size, tokenizer,
    state_dict of the SpeechModel)."""
    from statecatcher_tpu_torch.tokenizer import load_tokenizer
    from statecatcher_tpu_torch.train.checkpoint import CheckpointManager
    from statecatcher_tpu_torch.train.loop import build_tokenizer
    from statecatcher_tpu_torch.train.step import init_train_state

    run_tok = os.path.join(ckpt_dir, "tokenizer.json")
    if cfg.train.sp_model is None and os.path.exists(run_tok):
        tokenizer = load_tokenizer(run_tok)
    else:
        tokenizer = build_tokenizer(cfg)
    model_cfg = dataclasses.replace(cfg.model, vocab_size=tokenizer.vocab_size)
    cfg = dataclasses.replace(cfg, model=model_cfg)
    model = build_speech_model(model_cfg, frontend_feat_dim(cfg.frontend), cfg.train.mode,
                               device=device)
    state = init_train_state(model, cfg)
    state, _, _ = CheckpointManager(ckpt_dir).restore(state, model.init_state(1))
    return cfg, tokenizer, model.state_dict()


def main(argv=None) -> int:
    from statecatcher_tpu_torch.cli import _pop

    argv = list(sys.argv[1:] if argv is None else argv)
    ckpt_dir = _pop(argv, "--ckpt")
    decoder = _pop(argv, "--decoder") or "greedy"
    max_batches = int(_pop(argv, "--max-batches") or 10)
    device = _pop(argv, "--device") or "cuda"
    cfg = Config().apply_overrides(argv)
    if ckpt_dir is None:
        print("--ckpt <run_dir> is required", file=sys.stderr)
        return 1
    cfg, tokenizer, params = load_run(ckpt_dir, cfg, device)
    result = evaluate(cfg, params, tokenizer, max_batches=max_batches, decoder=decoder,
                      device=device)
    print(f"WER: {result.wer:.4f}  CER: {result.cer:.4f}  "
          f"({result.num_utterances} utterances, {result.num_segments} segments)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
