"""The training loop: session → batches → segment groups → carried state.

Port of ``statecatcher_tpu/train/loop.py`` for one process on one device:

  while True:
    fetch a recording batch (prefetched in the background)
    K = min|max segment count (clipping|padding strategy)
    carry = zero state                     # reset per recording batch
    for each group of ≤ segments_per_dispatch segments:
        assemble the group (int16 audio, prefix lengths) into reusable
        (pinned, on the card) host buffers → device → segment-group step
    mark the batch done

with the JAX package's bookkeeping: per-segment losses resolved one dispatch
late (so the host prepares the next group while the device works), the
hallucination filter (per-utterance losses z-scored against a rolling
median/MAD window; a flagged recording's remaining segments train with
``row_valid=False``), the tokenizer snapshot, and full-session checkpoints
(parameters, optimizer state, carry, the cursor {batches_done, seg_idx} and
the metrics window) from which a run resumes mid-recording-batch exactly.

Both training modes run (``train.mode`` "ctc" or "rnnt"; the step holds
the difference), over either data source (``data.source`` "local", or
"http": ``data/client.py``'s session against the speechcatcher-data API,
whose tokenizer must be named by ``train.sp_model``).  ``train.debug`` turns
on autograd's anomaly mode for the run and checks the carry at its end;
``train.profile_dir`` traces the run with ``torch.profiler`` (``debug.py``).

Under ``torch.distributed`` (one process per GPU, ``parallel/distributed.py:
initialize_distributed``) every rank runs this loop on a ``dp × mp`` mesh
(``parallel/mesh.py``; ``mesh.data_parallel`` -1 is world // mp, and dp·mp
must be the world), as the JAX loop runs under ``jax.distributed``:

  * rank 0 makes the run directory (``shared_run_dir`` hands it to every
    rank), saves the tokenizer and logs to the sinks;
  * a data rank owns B/dp rows; only the first rank of each model group
    reads data (its own local shard: files i ≡ d mod dp, or its own HTTP
    session) and hands each recording batch to the other ranks of its group,
    which train on the same rows; it alone marks batches done;
  * K and the token padding U are agreed over every rank (``sync_int``);
  * ``model_parallel > 1`` is tensor parallel (the gate projections cut to
    the rank's columns; "auto" becomes "pallas", as in JAX), or, with
    ``kernel_impl="sp"``, sequence parallel;
  * checkpoints hold the whole model and the global-B carry (rank 0 writes
    them); on resume each rank takes its shards and rows, so a run resumes
    on another world size.

One process trains unsharded whatever ``mesh`` says, as the JAX loop does
when ``data_parallel`` exceeds its devices.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import logging
import os
from typing import Optional

import numpy as np
import torch

from statecatcher_tpu_torch import resolve_device
from statecatcher_tpu_torch import debug
from statecatcher_tpu_torch.config import Config
from statecatcher_tpu_torch.data.client import SpeechDataset
from statecatcher_tpu_torch.data.local import LocalSpeechDataset
from statecatcher_tpu_torch.data.pipeline import (
    BatchPipeline,
    GroupBufferPool,
    assemble_compact_group,
    stack_segment_slice,
)
from statecatcher_tpu_torch.decode import keep_to_token_lists
from statecatcher_tpu_torch.frontend import feat_dim as frontend_feat_dim
from statecatcher_tpu_torch.metrics import (
    LossOutlierDetector,
    MultiSink,
    StageTimer,
    ThroughputMeter,
    make_sinks,
    wer,
)
from statecatcher_tpu_torch.models.speech import build_speech_model
from statecatcher_tpu_torch.ops import launch_counts
from statecatcher_tpu_torch.parallel.distributed import shared_run_dir, sync_int, world_group
from statecatcher_tpu_torch.parallel.mesh import make_mesh_plan, shard_model_tp
from statecatcher_tpu_torch.tokenizer import CharTokenizer, load_tokenizer
from statecatcher_tpu_torch.train.checkpoint import CheckpointManager, setup_run_dir
from statecatcher_tpu_torch.train.step import init_train_state, make_segment_scan_step

logger = logging.getLogger("statecatcher.train")


def _setup_logging(run_dir: str, rank: int = 0):
    root = logging.getLogger("statecatcher")
    root.setLevel(logging.INFO)
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    fh = logging.FileHandler(os.path.join(run_dir, "train.log" if rank == 0
                                          else f"train.rank{rank}.log"))
    fh.setFormatter(fmt)
    root.addHandler(fh)
    if not any(isinstance(h, logging.StreamHandler) for h in root.handlers):
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        root.addHandler(sh)
    return fh


def build_dataset(cfg: Config, shard_index: int = 0, shard_count: int = 1):
    """The data source of ``cfg``; a local directory is striped over
    ``shard_count`` data ranks (files i ≡ ``shard_index``)."""
    if cfg.data.source == "local":
        if not cfg.data.local_dir:
            raise ValueError("data.source=local requires data.local_dir")
        return LocalSpeechDataset(
            cfg.data.local_dir,
            batch_segment_strategy=cfg.data.batch_segment_strategy,
            batch_samplerate=cfg.data.batch_samplerate,
            shard_index=shard_index,
            shard_count=shard_count,
        )
    return SpeechDataset(
        config_path=cfg.data.config_path,
        batch_segment_strategy=cfg.data.batch_segment_strategy,
        batch_samplerate=cfg.data.batch_samplerate,
    )


def build_tokenizer(cfg: Config):
    """Load the configured tokenizer, or auto-train a char tokenizer from
    local VTTs."""
    if cfg.train.sp_model:
        return load_tokenizer(cfg.train.sp_model)
    if cfg.data.source == "local" and cfg.data.local_dir:
        from statecatcher_tpu_torch.data.vtt import vtt_to_segments_with_text

        corpus = []
        for name in sorted(os.listdir(cfg.data.local_dir)):
            if name.endswith(".vtt"):
                with open(os.path.join(cfg.data.local_dir, name)) as f:
                    for _, _, text in vtt_to_segments_with_text(f.read()):
                        corpus.append(text)
        logger.info("Auto-training char tokenizer from %d cues", len(corpus))
        return CharTokenizer.train(corpus or ["abcdefghijklmnopqrstuvwxyz "])
    raise ValueError("train.sp_model is required for http data source")


def _mesh_plan(cfg: Config):
    """The mesh of this process group, or None for one process (which trains
    unsharded, as the JAX loop does when the mesh exceeds its devices)."""
    world = world_group()
    if world.size == 1:
        return None
    mp = max(1, cfg.mesh.model_parallel)
    dp = cfg.mesh.data_parallel if cfg.mesh.data_parallel > 0 else world.size // mp
    if dp * mp != world.size:
        raise ValueError(f"multi-process training needs every rank in the mesh: "
                         f"{dp}x{mp} over {world.size} ranks")
    return make_mesh_plan(cfg.mesh, sequence_parallel=cfg.model.lucyrnn.kernel_impl == "sp")


def train(
    cfg: Config,
    dataset=None,
    max_batches: Optional[int] = None,
    initial_params=None,
    device="cuda",
) -> dict:
    """Run training.  Returns a summary dict (final step, losses, run_dir).

    ``initial_params``: a state_dict of the port's SpeechModel (for example
    ``convert.flax_to_torch`` of JAX parameters) to start from instead of
    the seeded initialisation.  ``device`` is where the model trains; a CUDA
    device without a card raises.  In a process group
    (``initialize_distributed``) every rank calls it with its own device; the
    ``dataset`` given is read by the first rank of each model group.
    """
    dev = resolve_device(device)
    launches0 = launch_counts()
    plan = _mesh_plan(cfg)
    if plan is None:
        run_dir = setup_run_dir(cfg)
    else:
        # one run directory for every rank
        run_dir = shared_run_dir(setup_run_dir(cfg) if plan.is_primary else "")
    log_handler = _setup_logging(run_dir, 0 if plan is None else plan.world.index)
    logger.info("Run directory: %s", run_dir)
    try:
        with contextlib.ExitStack() as stack:
            if cfg.train.debug:
                debug.enable_debug()
                stack.callback(debug.disable_debug)
            if cfg.train.profile_dir:
                stack.enter_context(debug.profile(cfg.train.profile_dir))
            summary, carry = _train(cfg, dataset, max_batches, initial_params, dev, run_dir,
                                    plan)
        if cfg.train.debug and summary["global_step"] > 0:
            if plan is not None:
                carry = plan.gather_rows(carry)          # the global batch's carry
            B = cfg.data.batch_size
            n = debug.check_carry(carry, batch_size=B)
            logger.info("debug: check_carry passed (%d leaves finite, batch-major, B=%d)", n, B)
        summary["kernel_launches"] = {k: n - launches0[k] for k, n in launch_counts().items()
                                      if n > launches0[k]}
        return summary
    finally:
        logging.getLogger("statecatcher").removeHandler(log_handler)
        log_handler.close()


def _train(cfg: Config, dataset, max_batches, initial_params, dev, run_dir, plan) -> tuple:
    """The body of ``train``: the summary dict and this rank's last carry."""
    primary = plan is None or plan.is_primary
    # the first rank of each model group reads the data of its rows
    reader = plan is None or plan.model.index == 0
    tokenizer = build_tokenizer(cfg)
    vocab_size = tokenizer.vocab_size
    blank_id = tokenizer.blank_id
    logger.info("Vocab size: %d (blank_id=%d)", vocab_size, blank_id)
    if hasattr(tokenizer, "save") and primary:
        # snapshot next to the checkpoints so eval/inference reconstructs the
        # exact token mapping
        tokenizer.save(os.path.join(run_dir, "tokenizer.json"))

    model_cfg = dataclasses.replace(cfg.model, vocab_size=vocab_size)
    if plan is not None and plan.tensor_parallel and model_cfg.lucyrnn.kernel_impl == "auto":
        # as in JAX: tensor-parallel runs keep the split path (K5)
        model_cfg = dataclasses.replace(model_cfg, lucyrnn=dataclasses.replace(
            model_cfg.lucyrnn, kernel_impl="pallas"))
    fdim = frontend_feat_dim(cfg.frontend)
    model = build_speech_model(model_cfg, fdim, cfg.train.mode, device=dev,
                               generator=torch.Generator().manual_seed(cfg.train.seed))
    if initial_params is not None:
        sd = {k: torch.as_tensor(np.asarray(v)) for k, v in initial_params.items()}
        model.load_state_dict(sd)                        # strict: names and shapes match
    n_params = sum(p.numel() for p in model.parameters())
    if plan is not None and plan.tensor_parallel:
        shard_model_tp(model, plan)                      # this rank's rows of each sharded leaf

    sr = cfg.data.batch_samplerate
    target_samples = int(sr * cfg.data.target_duration)
    B = cfg.data.batch_size if plan is None else plan.local_batch(cfg.data.batch_size)

    state = init_train_state(model, cfg, plan)
    logger.info("Model built: %s, feat_dim=%d, vocab=%d, params=%.2fM, device=%s%s",
                model_cfg.encoder, fdim, vocab_size, n_params / 1e6, dev,
                "" if plan is None else f", mesh {plan.data_size}x{plan.model_size} "
                f"({'sequence' if plan.sequence_parallel else 'tensor'} parallel model axis), "
                f"{B} rows/rank")

    ckpt = CheckpointManager(run_dir)
    start_epoch = 0
    global_step = 0
    resume_cursor = None      # {"batches_done": N, "seg_idx": s} if mid-session
    resume_carry = None       # carry at the checkpointed boundary
    resume_window = None      # metrics window at the checkpointed boundary
    if cfg.train.resume_from:
        prev = CheckpointManager(cfg.train.resume_from)
        state, meta, resume_carry = prev.restore(state, model.init_state(B), plan)
        global_step = int(meta["global_step"])
        start_epoch = int(meta["epoch"])
        resume_cursor = meta.get("cursor")
        resume_window = meta.get("metrics_window")
        logger.info("Resumed from %s at step %d (epoch %d, cursor=%s, carry=%s)",
                    cfg.train.resume_from, global_step, start_epoch, resume_cursor,
                    "restored" if resume_carry is not None else "absent")

    train_step = make_segment_scan_step(model, cfg, blank_id=blank_id,
                                        ctc_impl=cfg.train.ctc_impl, mesh_plan=plan)

    if not reader:
        dataset = None
    elif dataset is None:
        dataset = (build_dataset(cfg) if plan is None
                   else build_dataset(cfg, plan.data.index, plan.data_size))
    if dataset is not None:
        dataset.start_session(
            batch_size=B, order=cfg.data.order,
            min_duration=cfg.data.min_duration, max_duration=cfg.data.max_duration,
        )

    sinks = make_sinks(logger, run_dir) if primary else MultiSink([])
    sinks.set_params({
        "encoder": model_cfg.encoder, "frontend": cfg.frontend.kind,
        "mode": cfg.train.mode, "lr": cfg.train.optim.lr,
        "batch_samplerate": sr, "target_duration": cfg.data.target_duration,
        "optimizer": cfg.train.optim.optimizer,
        "max_grad_norm": cfg.train.optim.max_grad_norm,
        "epochs": cfg.train.epochs,
        "accumulation_steps": cfg.train.optim.accumulation_steps,
        "num_params": int(n_params),
    })

    timer = StageTimer()
    meter = ThroughputMeter()
    # raw per-segment loss sequence (the windowed `losses` is cleared at each
    # log flush)
    loss_history: collections.deque = collections.deque(maxlen=100_000)
    losses: list[float] = []
    window_refs: list[str] = []
    window_hyps: list[str] = []
    if resume_window:
        losses.extend(resume_window.get("losses", []))
        window_refs.extend(resume_window.get("refs", []))
        window_hyps.extend(resume_window.get("hyps", []))
    prev_epoch = None
    n_batches = 0
    stop = False
    pending = None  # deferred metrics of the in-flight dispatch
    halluc = None
    if cfg.train.hallucination_zscore > 0:
        halluc = LossOutlierDetector(
            cfg.train.hallucination_zscore,
            cfg.train.hallucination_window,
            cfg.train.hallucination_min_window,
            cfg.train.hallucination_min_rel,
        )
    carry = None
    compact_checked = False      # one-time prefix-mask check
    compact_err_checked = False  # one-time int16-grid probe (first FLOAT group)
    # reusable double-buffered group buffers, page-locked when they go to a card
    compact_pool = GroupBufferPool(pin_memory=dev.type == "cuda")
    # data-session cursor: recording batches fully processed, and the next
    # segment of the in-flight batch; saved with every checkpoint
    cursor = {"batches_done": 0, "seg_idx": 0}
    skip_batches = 0
    resume_seg = 0
    if resume_cursor:
        skip_batches = int(resume_cursor.get("batches_done", 0))
        resume_seg = int(resume_cursor.get("seg_idx", 0))
        cursor = {"batches_done": skip_batches, "seg_idx": resume_seg}
    batches_done_total = skip_batches

    def _resolve_metrics(p):
        outs, group, last_texts, rows, audio_secs, step_at, \
            row_real, quarantined, batch_ident = p
        loss_vals = outs.loss[:group].cpu().numpy()
        losses.extend(float(x) for x in loss_vals)
        loss_history.extend(float(x) for x in loss_vals)
        meter.step(audio_secs)
        if halluc is not None:
            pl = outs.per_loss.cpu().numpy()[:group]
            for k in range(group):
                # detrend against the contemporaneous group median (the raw
                # per-utterance NLL falls as training progresses)
                cur = [
                    float(pl[k, i]) for i in range(min(rows, pl.shape[1]))
                    if row_real[k, i] and not quarantined[i]
                    and np.isfinite(pl[k, i])
                ]
                if not cur:
                    continue
                group_med = float(np.median(cur))
                for i in range(min(rows, pl.shape[1])):
                    if quarantined[i] or not row_real[k, i]:
                        continue
                    if halluc.update(float(pl[k, i]) - group_med, scale=group_med):
                        quarantined[i] = True
                        msg = (
                            "hallucination filter: quarantined row "
                            f"{i} of batch {batch_ident} (per-utterance "
                            f"loss {pl[k, i]:.3f}, robust z > "
                            f"{cfg.train.hallucination_zscore:g})"
                        )
                        logger.warning(msg)
                        if dataset is not None:
                            try:
                                dataset.log("WARNING", msg)
                            except Exception:
                                pass
        if len(losses) >= cfg.train.log_every_n:
            with timer.time("metrics"):
                last = group - 1
                hyp_lists = keep_to_token_lists(outs.preds[last], outs.keep[last])
                for i in range(rows):
                    window_hyps.append(tokenizer.decode_ids(hyp_lists[i]))
                    window_refs.append(last_texts[i])
                avg_loss = sum(losses) / len(losses)
                ter = wer(window_refs, window_hyps)
                sinks.track(avg_loss, f"avg_loss_{cfg.train.log_every_n}", step_at)
                sinks.track(ter, f"train_ter_{cfg.train.log_every_n}", step_at)
                sinks.track(float(outs.grad_norm[last]), "grad_norm", step_at)
                sinks.track(meter.audio_seconds_per_second, "audio_sec_per_sec", step_at)
                if halluc is not None:
                    sinks.track(halluc.flagged, "hallucination_quarantined", step_at)
                losses.clear()
                window_refs.clear()
                window_hyps.clear()

    def save(epoch, step=None):
        nonlocal pending
        if pending is not None:
            # fold the in-flight dispatch into the windows so the saved
            # metrics state matches the saved cursor exactly
            _resolve_metrics(pending)
            pending = None
        ckpt.save(
            step if step is not None else global_step,
            state,
            {
                "epoch": int(epoch),
                "global_step": int(global_step),
                "cursor": dict(cursor),
                "metrics_window": {
                    "losses": list(losses),
                    "refs": list(window_refs),
                    "hyps": list(window_hyps),
                },
            },
            carry=carry,
            mesh_plan=plan,
        )

    def to_device(x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev, non_blocking=True)

    pipe = None
    if dataset is not None:
        pipe = BatchPipeline(
            dataset, target_samples, num_workers=cfg.data.num_workers,
            prefetch=cfg.data.prefetch_batches,
        ).start()

    def fetch():
        """The next recording batch; the model group's reader hands its
        batch to the other ranks of the group."""
        if plan is None or plan.model_size == 1:
            return pipe.get()
        if pipe is None:
            got = plan.model.broadcast_object(None)
            if isinstance(got, str):
                raise RuntimeError(f"the model group's reader failed: {got}")
            return got
        try:
            got = pipe.get()
        except BaseException as e:
            plan.model.broadcast_object(f"{type(e).__name__}: {e}")
            raise
        return plan.model.broadcast_object(got)

    try:
        while not stop:
            with timer.time("fetch"):
                batch = fetch()
            if skip_batches > 0:
                # resume replay: the checkpointed session already processed
                # this batch; consume and discard to restore data position
                skip_batches -= 1
                prev_epoch = batch.epoch
                continue
            epoch = batch.epoch

            if prev_epoch is None:
                prev_epoch = epoch
            elif epoch != prev_epoch:
                save(prev_epoch)
                if prev_epoch + 1 >= cfg.train.epochs:
                    break
                prev_epoch = epoch
            if epoch >= cfg.train.epochs:
                break

            K = batch.num_segments(cfg.data.batch_segment_strategy)
            # every rank must agree on the segment count of the global batch
            K = sync_int(K, "min" if cfg.data.batch_segment_strategy == "clipping" else "max")
            n_rows = len(batch.audio_items)
            quarantined = np.zeros(B, bool)

            # reset the carry at each new recording batch; on the first batch
            # after a mid-recording-batch resume, restore the checkpointed
            # carry and re-enter at the saved segment instead
            seg_idx = 0
            if resume_seg > 0:
                seg_idx = min(resume_seg, K)
                resume_seg = 0
                if resume_carry is None:
                    raise RuntimeError(
                        "resume cursor is mid-recording-batch but the checkpoint has no carry")
                carry = resume_carry
                resume_carry = None
            else:
                carry = model.init_state(B)
            KG = max(1, cfg.train.segments_per_dispatch)

            while seg_idx < K and not stop:
                # group of up to KG segments, capped so step limits are exact
                group = min(KG, K - seg_idx)
                if cfg.train.steps:
                    group = min(group, cfg.train.steps - global_step)
                group_ids = list(range(seg_idx, seg_idx + group))
                seg_idx += group

                with timer.time("host_prep"):
                    if cfg.train.compact_transfer:
                        # single-pass assembly straight into the final
                        # (KG, B, S) transfer buffer: int16 passthrough and
                        # prefix lengths instead of stacked bool masks
                        audio_k, lens_k, g_texts = assemble_compact_group(
                            batch, group_ids, KG, B, target_samples, pool=compact_pool,
                        )
                        g_tokens = [[tokenizer.encode(t) for t in g_texts[gi]]
                                    for gi in range(group)]
                        if not compact_checked:
                            # masks must be PREFIX masks for the lens form
                            compact_checked = True
                            for mi in batch.mask_items:
                                for si in group_ids:
                                    if si >= len(mi):
                                        continue
                                    m = mi[si]
                                    nnz = int(np.count_nonzero(m))
                                    if not (m[:nnz].all() and not m[nnz:].any()):
                                        raise ValueError(
                                            "train.compact_transfer requires prefix sample "
                                            "masks; got a mask with interior zeros — disable "
                                            "compact_transfer or fix the data plane")
                        if audio_k.dtype != np.int16:
                            # float-sourced / resampled rows: quantize to int16
                            audio_q = np.clip(
                                np.rint(audio_k * 32767.0), -32768.0, 32767.0
                            ).astype(np.int16)
                            if not compact_err_checked and audio_k.size:
                                compact_err_checked = True
                                err = float(np.max(np.abs(audio_q / 32767.0 - audio_k)))
                                if err > 1e-6:
                                    logger.info(
                                        "compact_transfer: audio not on the int16 grid "
                                        "(max quantization error %.2e/sample); set "
                                        "train.compact_transfer=false for bit-exact "
                                        "transfer", err)
                            audio_k = audio_q
                        mask_k = lens_k
                    else:
                        g_audio, g_mask, g_texts, g_tokens = [], [], [], []
                        for si in group_ids:
                            audio, mask, texts = stack_segment_slice(batch, si, target_samples)
                            if n_rows < B:  # pad to the batch shape
                                pad = B - n_rows
                                audio = np.pad(audio, ((0, pad), (0, 0)))
                                mask = np.pad(mask, ((0, pad), (0, 0)))
                                texts = texts + [""] * pad
                            g_audio.append(audio)
                            g_mask.append(mask)
                            g_texts.append(texts)
                            g_tokens.append([tokenizer.encode(t) for t in texts])
                        while len(g_audio) < KG:        # pad the group with invalid segments
                            g_audio.append(np.zeros_like(g_audio[0]))
                            g_mask.append(np.zeros_like(g_mask[0]))
                            g_texts.append([""] * B)
                        audio_k = np.stack(g_audio)
                        mask_k = np.stack(g_mask)
                    row_valid = np.broadcast_to(
                        (np.arange(B) < n_rows) & ~quarantined, (KG, B))
                    seg_valid = np.arange(KG) < group
                    # common token padding across the group, bucketed to 16
                    flat = [t for seg in g_tokens for t in seg]
                    U = max(max((len(t) for t in flat), default=1), 1)
                    U = sync_int(-(-U // 16) * 16, "max")
                    tokens = np.full((KG, B, U), blank_id, dtype=np.int32)
                    tgt_lens = np.zeros((KG, B), dtype=np.int32)
                    for gi, seg in enumerate(g_tokens):
                        for bi, t in enumerate(seg):
                            tgt_lens[gi, bi] = len(t)
                            if t:
                                tokens[gi, bi, : len(t)] = np.asarray(t, np.int32)
                    # a row joins the outlier statistics only when its segment
                    # is real: within its recording and with tokens
                    counts = np.zeros(B, np.int64)
                    counts[:n_rows] = batch.num_segments_per_item
                    gid = np.full(KG, np.iinfo(np.int64).max)
                    gid[:len(group_ids)] = group_ids
                    row_real = row_valid & (gid[:, None] < counts[None, :]) & (tgt_lens > 0)
                with timer.time("train_step"):
                    args = [to_device(x) for x in (audio_k, mask_k, tokens, tgt_lens, row_valid)]
                    compact_pool.fence()
                    state, carry, outs = train_step(state, carry, *args, seg_valid)

                global_step += group
                cursor = {"batches_done": batches_done_total, "seg_idx": seg_idx}
                # resolve the PREVIOUS dispatch's metrics now (one dispatch of
                # lag keeps the device busy during host-side prep/decoding)
                if pending is not None:
                    _resolve_metrics(pending)
                pending = (
                    outs, group, g_texts[group - 1], n_rows,
                    float(mask_k[:group].sum()) / sr,
                    global_step, row_real, quarantined, batch.batch_id,
                )

                if (cfg.train.save_every_n_updates
                        and global_step % cfg.train.save_every_n_updates < group):
                    save(epoch)

                if cfg.train.steps and global_step >= cfg.train.steps:
                    stop = True

            if dataset is not None:
                with timer.time("mark_done"):
                    dataset.mark_batch_done(epoch, batch.batch_id)
                dataset.log("INFO", f"Completed batch {batch.batch_id} @ epoch {epoch}")
            n_batches += 1
            batches_done_total += 1
            if seg_idx >= K:
                # only a fully-processed batch advances the resume cursor; a
                # steps-limit stop mid-batch keeps {batches_done, seg_idx}
                # pointing at the unprocessed remainder
                cursor = {"batches_done": batches_done_total, "seg_idx": 0}
            if max_batches and n_batches >= max_batches:
                break
    finally:
        if pending is not None:
            _resolve_metrics(pending)
            pending = None
        if pipe is not None:
            pipe.stop()
            dataset.end_session()
        save(prev_epoch if prev_epoch is not None else 0)
        sinks.close()
        logger.info("Stage timing: %s", timer.summary())

    return {
        "run_dir": run_dir,
        "global_step": global_step,
        "final_loss": loss_history[-1] if loss_history else None,
        "loss_history": list(loss_history),
        "audio_sec_per_sec": meter.audio_seconds_per_second,
        "stage_timing": timer.summary(),
        "hallucination_quarantined": halluc.flagged if halluc else 0,
    }, carry
