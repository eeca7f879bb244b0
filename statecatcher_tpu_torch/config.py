"""Config tree for statecatcher_tpu_torch.

The PyTorch port keeps its own copy of the JAX package's config tree
(``statecatcher_tpu/config.py``), field for field, so that the same
``--model.hidden_size 512`` overrides build the same model in both packages.

The reference drives everything through a flat argparse surface of ~40 flags
(reference train.py:608-655) plus a YAML file for data-plane credentials
(reference dataset.py:20-31).  Here the same surface is a typed dataclass tree
(model / data / train / mesh) with CLI overrides (``--train.lr 1e-3`` style)
and the same YAML for credentials, so configs serialize cleanly to JSON next
to checkpoints (parity with reference train.py:62-66 ``training_args.json``).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass(frozen=True)
class FrontendConfig:
    """Feature frontend (reference model.py:250-279)."""

    kind: str = "mfcc"  # "mfcc" | "mel"
    sample_rate: int = 16000
    n_fft: int = 400          # 25 ms @ 16 kHz
    win_length: int = 400
    hop_length: int = 160     # 10 ms @ 16 kHz
    n_mels: int = 80
    n_mfcc: int = 80
    center: bool = False
    power: float = 2.0
    mel_scale: str = "htk"
    top_db: float = 80.0      # AmplitudeToDB clamp for kind="mel"
    log_mels: bool = True     # natural-log mels before DCT for kind="mfcc"


@dataclass(frozen=True)
class LucyRNNConfig:
    """LucyRNN cell family (reference lucyrnn_triton.py / lucyrnn.py).

    The canonical LucyRNN for parity is the reference's Triton variant
    (7 gates r,z,k,v,h_pre,decay,alpha + grouped RMS normalization;
    reference lucyrnn_triton.py:204-241) — reference model.py:308-310 always
    instantiates that one for ``encoder=lucyrnn``.  ``variant="native"``
    selects the distinct 6-gate LayerNorm cell the reference also ships
    (reference lucyrnn.py:8-70; SURVEY.md Appendix A.14) —
    models/lucyrnn_native.py.
    """

    hidden_dim: int = 512
    num_layers: int = 4
    num_tracks: int = 1
    variant: str = "triton"        # "triton" (7-gate) | "native" (6-gate)
    # -- native-variant knobs (reference lucyrnn_conf.py) --
    fused_ops: bool = False        # one fused 6D gate matmul vs six separate
    layer_norm: bool = True        # cell-internal LayerNorms on/off
    decay_mode: str = "learned"    # "learned" | "prefix_sum"
    lambda_decay: float = 0.001    # prefix_sum positional decay rate
    # Kernel implementation for the time recurrence:
    #   "auto"      — pallas on TPU, assoc elsewhere
    #   "pallas"    — fused Pallas scan kernel (TPU)
    #   "assoc"     — jax.lax.associative_scan (parallel-in-time, any backend)
    #   "chunked"   — chunk-vectorized scan (fast, slow to compile in grads)
    #   "xla-scan"  — jax.lax.scan (sequential reference semantics)
    kernel_impl: str = "auto"
    # If True, frames where mask==0 leave (h, s) unchanged.  The reference
    # ignores masks in the LucyRNN forward (lucyrnn_triton.py:111 accepts but
    # never reads `masks`); False reproduces that behavior.
    mask_state_updates: bool = False


@dataclass(frozen=True)
class XLSTMConfig:
    """mLSTM-block encoder (reference model.py:214-229 via NX-AI xLSTMLarge)."""

    embedding_dim: int = 512
    num_heads: int = 2
    num_blocks: int = 3
    # Chunkwise-parallel kernel chunk (the math is exact for any size; the
    # reference pads T to 64, model.py:305).  128 is the measured on-chip
    # winner at the flagship config — round-3 shootout, BASELINE.md:
    # chunkwise@128 7318 > pallas@128 7235 > chunkwise@64 7038 >
    # pallas@256 6971 audio-s/s; chunkwise@256 failed to compile in <9.5 min;
    # recurrent OOMs in training (decode-step form).  NOTE: the Pallas kernel
    # on a real TPU needs chunk_size % 128 == 0 (lane-aligned chunk offsets).
    chunk_size: int = 128
    # "auto" → the fused lane-major Pallas fwd+bwd kernel on TPU when head
    # slices are lane-aligned (dqk, dv, chunk_size % 128 == 0; measured 9638
    # vs chunkwise 7504 audio-s/s flagship — BASELINE.md round 5), else the
    # XLA chunkwise scan.  Explicit: chunkwise | recurrent | pallas | fused.
    kernel_impl: str = "auto"
    ffn_proj_factor: float = 2.667
    qk_dim_factor: float = 0.5
    v_dim_factor: float = 1.0
    gate_soft_cap: float = 15.0
    # Recompute SwiGLU FFN activations in the backward (jax.checkpoint):
    # trades the HBM-bound bwd activation reads for MXU recompute FLOPs.
    ffn_remat: bool = False


@dataclass(frozen=True)
class ModelConfig:
    encoder: str = "lstm"          # "lstm" | "lucyrnn" | "xlstm"
    hidden_size: int = 512
    num_layers: int = 4
    input_proj_dim: int = -1       # -1 = no input projection
    # Stack this many consecutive feature frames into one (time downsample ×
    # feature widen) before the encoder — reference lucyrnn.py:92-99.
    stack_order: int = 1
    vocab_size: int = 1024
    dtype: str = "float32"         # compute dtype for activations ("bfloat16" on TPU)
    param_dtype: str = "float32"
    # Dtype of the carried recurrent state BETWEEN segments.  "auto" = same as
    # `dtype`.  "float32" under bfloat16 activations avoids accumulating a
    # rounding per segment boundary on hour-long recordings (the reference
    # carries fp16 under AMP — reference train.py:515-526 — so this is the
    # strictly safer option it lacks).
    carry_dtype: str = "auto"
    lucyrnn: LucyRNNConfig = field(default_factory=LucyRNNConfig)
    xlstm: XLSTMConfig = field(default_factory=XLSTMConfig)
    # RNN-T predictor/joiner dims (reference train.py:638-639)
    rnnt_pred_emb_dim: int = 64
    rnnt_joiner_dim: int = 64


@dataclass(frozen=True)
class DataConfig:
    """Data plane (reference dataset.py + train.py data flags)."""

    config_path: str = "config.yaml"   # YAML with secret_api_key / server_api_url
    source: str = "http"               # "http" | "local" (file-backed fixture dataset)
    local_dir: Optional[str] = None    # for source="local"
    batch_samplerate: int = 16000
    batch_segment_strategy: str = "clipping"  # "clipping" | "padding"
    batch_size: int = 32
    order: str = "asc"                 # "asc" | "desc" | "random"
    min_duration: float = 0.0
    max_duration: Optional[float] = None
    target_duration: float = 16.0      # seconds per segment
    num_workers: int = 16              # prefetch/decode worker threads
    prefetch_batches: int = 2


@dataclass(frozen=True)
class OptimConfig:
    optimizer: str = "adam"       # "adam" | "adamw" | "lion"
    lr: float = 3e-4
    weight_decay: float = 1e-2
    beta1: float = 0.9
    beta2: float = 0.98
    use_scheduler: bool = False   # warmup + cosine (reference train.py:147-157)
    warmup_steps: int = 10000
    total_steps: int = 100000
    accumulation_steps: int = 1
    max_grad_norm: float = 50.0


@dataclass(frozen=True)
class TrainConfig:
    mode: str = "ctc"             # "ctc" | "rnnt"
    # "auto" = pallas on TPU (fastest measured), optax elsewhere.
    ctc_impl: str = "auto"        # "auto" | "optax" | "lattice" | "pallas"
    # Transducer joint implementation: "pallas" = fused VMEM-resident joint
    # kernel (ops/rnnt_pallas.py, ~4× faster at flagship shapes); "xla" =
    # remat-chunked XLA path (ops/rnnt.py:rnnt_loss_fused, runs anywhere);
    # "auto" = pallas on TPU, xla elsewhere.
    rnnt_impl: str = "auto"
    # Time-chunk for the XLA fused transducer loss: the (B, chunk, U+1, V)
    # joint is the only transient; smaller = less HBM pressure, more steps.
    rnnt_time_chunk: int = 16
    # Time-block per Pallas joint grid step; 8 keeps the backward tile under
    # the 16 MB VMEM budget at vocab 1024.
    rnnt_time_block: int = 8
    # Banded (pruned) transducer: restrict u per time-block to a window of
    # this width centered on each utterance's alignment diagonal
    # (ops/rnnt_band.py) — cuts the T×U×V softmax work by ~U/band.  0 = the
    # exact full lattice (proven VPU-exp-bound at U=128, so banding is the
    # remaining throughput lever).  -1 (default) = auto: the step picks
    # per U bucket at trace time — exact for padded U ≤ 48, band 32 above
    # it (+5 % at U=64, +59 % at U=128; BASELINE.md round-5 crossover).
    rnnt_band: int = -1
    # On-the-fly hallucination / bad-transcript filtering (the reference's
    # last roadmap item, reference README.md:30): per-utterance losses are
    # z-scored against a rolling median/MAD window
    # (metrics.LossOutlierDetector); a flagged recording is quarantined —
    # its remaining segments train with row_valid=False — and reported via
    # the dataset's log endpoint.  0 disables.
    hallucination_zscore: float = 6.0
    hallucination_window: int = 512        # rolling window of recent losses
    hallucination_min_window: int = 64     # no flagging before this many
    # relative-excess floor: flag only when the loss also exceeds the group
    # median by this fraction (MAD collapses on homogeneous batches and
    # harmless ~1 % deviations would z-score as outliers)
    hallucination_min_rel: float = 0.05
    epochs: int = 10
    steps: Optional[int] = None
    optim: OptimConfig = field(default_factory=OptimConfig)
    sp_model: Optional[str] = None    # tokenizer model path
    model_dir: str = "models"
    save_every_n_updates: Optional[int] = None
    log_every_n: int = 100            # metrics window (reference train.py:215)
    # Segments per device dispatch: the K-segment loop runs as an on-device
    # lax.scan in groups of this size (carry threads through); 1 = per-segment
    # dispatch like the reference host loop.  24 amortizes the per-dispatch
    # host round-trip (round-5 sweep at the hand-adjoint kernels: 24 beat 16
    # in three paired runs, ~+1.5 %; 32 gives it back; recordings shorter
    # than the group just use smaller final groups).
    segments_per_dispatch: int = 24
    # Compact host→device transfer: ship audio as int16 PCM (de-quantized on
    # device — within 1 ulp of the host float32 division for the PCM-derived
    # audio the data plane decodes) and sample masks as (K, B) prefix lengths
    # (bit-exact) instead of (K, B, S) bools — 5× fewer bytes over
    # PCIe/tunnel per dispatch.  False = raw float32 + bool masks (debugging,
    # or non-PCM synthetic audio where quantization would perturb by ≤3e-5).
    compact_transfer: bool = True
    seed: int = 0
    # On-the-fly bad-segment filtering (the reference lists "hallucination
    # detection & filtering" as planned-only, reference README.md:30):
    # skip the optimizer update AND freeze the carry for a segment whose loss
    # is non-finite or above this threshold (None = only non-finite).
    skip_loss_above: Optional[float] = None
    skip_nonfinite_updates: bool = True
    debug: bool = False               # enables debug_nans + state-detach checks
    profile_dir: Optional[str] = None # jax.profiler trace output
    resume_from: Optional[str] = None # checkpoint dir to resume (new capability;
                                      # the reference has save-only checkpoints)


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh for pjit sharding.

    The reference is single-process single-device; the mesh is our build's
    first-class scaling axis (SURVEY.md §2.3).  data: batch + carry-state
    sharding with XLA-emitted gradient allreduce; model: optional hidden-dim
    sharding of the recurrent cells (the scan is elementwise in D).
    """

    data_parallel: int = -1      # -1 = all available devices
    model_parallel: int = 1
    # Mesh axis used by sequence/context-parallel scans when the encoder is
    # configured with model.lucyrnn.kernel_impl="sp" (ops/scan_sp.py): the
    # segment's time axis shards over this axis inside the recurrence.
    sequence_axis: str = "model"


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    frontend: FrontendConfig = field(default_factory=FrontendConfig)

    # ------------------------------------------------------------------ #
    # (De)serialization
    # ------------------------------------------------------------------ #
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), indent=2, **kw)

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        return _dataclass_from_dict(cls, d)

    @classmethod
    def from_json(cls, s: str) -> "Config":
        return cls.from_dict(json.loads(s))

    # ------------------------------------------------------------------ #
    # CLI overrides: ["--train.optim.lr", "1e-3", "--model.encoder", "lucyrnn"]
    # ------------------------------------------------------------------ #
    def apply_overrides(self, argv: list[str]) -> "Config":
        cfg = self
        i = 0
        while i < len(argv):
            tok = argv[i]
            if not tok.startswith("--"):
                raise ValueError(f"Expected --key, got {tok!r}")
            key = tok[2:]
            if "=" in key:
                key, raw = key.split("=", 1)
                i += 1
            else:
                if i + 1 >= len(argv):
                    raise ValueError(f"Missing value for {tok!r}")
                raw = argv[i + 1]
                i += 2
            cfg = _set_by_path(cfg, key.replace("-", "_"), raw)
        return cfg


def _dataclass_from_dict(cls, d):
    if not dataclasses.is_dataclass(cls):
        return d
    kwargs = {}
    hints = {f.name: f for f in dataclasses.fields(cls)}
    for k, v in d.items():
        if k not in hints:
            # Tolerate fields removed in newer versions when loading saved
            # run configs (CLI overrides stay strict via _set_by_path).
            import warnings

            warnings.warn(f"Ignoring unknown config field {k!r} for {cls.__name__}")
            continue
        f = hints[k]
        sub = f.default_factory() if f.default_factory is not dataclasses.MISSING else None  # type: ignore[misc]
        if sub is not None and dataclasses.is_dataclass(sub) and isinstance(v, dict):
            kwargs[k] = _dataclass_from_dict(type(sub), v)
        else:
            kwargs[k] = v
    return cls(**kwargs)


def _coerce(old: Any, raw: str) -> Any:
    if raw.lower() in ("none", "null"):
        return None
    if isinstance(old, bool):
        return raw.lower() in ("1", "true", "yes", "on")
    if isinstance(old, int) and not isinstance(old, bool):
        return int(raw)
    if isinstance(old, float):
        return float(raw)
    if old is None:
        # untyped Optional field: try int, float, then string
        for conv in (int, float):
            try:
                return conv(raw)
            except ValueError:
                pass
        return raw
    return raw


def _set_by_path(cfg, dotted: str, raw: str):
    parts = dotted.split(".")
    def rec(node, idx):
        name = parts[idx]
        if not hasattr(node, name):
            raise ValueError(f"Unknown config path {dotted!r} (no field {name!r} on {type(node).__name__})")
        cur = getattr(node, name)
        if idx == len(parts) - 1:
            return dataclasses.replace(node, **{name: _coerce(cur, raw)})
        return dataclasses.replace(node, **{name: rec(cur, idx + 1)})
    return rec(cfg, 0)
