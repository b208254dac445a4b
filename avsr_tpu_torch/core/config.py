"""Typed configuration of the PyTorch port.

A copy of the sections of ``avsr_tpu.core.config`` that the port reads
(``data``, ``model`` with its Whisper/CLIP/LLM/LoRA subsections,
``training``, ``mesh``, ``runtime``, ``decode``), with the same field names
and defaults, so that a YAML file written for the JAX package loads here
unchanged. Knobs whose feature is not ported raise ``NotImplementedError``
at validation rather than being ignored: mesh axes above 1, optimizers
other than AdamW, SpecAugment, video augmentation, layer-norm unfreezing
and the batch-size probe. ``mesh.donate`` is accepted and means nothing
here: it is an XLA buffer-donation hint, and eager PyTorch updates the
train state in place anyway.

PyYAML is imported only inside :func:`load_config`: the flagship config is
also built in Python by :func:`flagship`, which mirrors
``avsr_tpu/configs/base.yaml`` for hosts without PyYAML.
"""

from __future__ import annotations

import dataclasses
import typing
from dataclasses import dataclass, field, fields, is_dataclass
from pathlib import Path
from typing import Any

MODALITIES = ("audio", "video", "both")
CONNECTOR_TYPES = ("simple", "deep", "conv", "attention", "adaptive",
                   "cross_modal", "qformer", "perceiver", "adapter", "moe")
OPTIMIZERS = ("adamw", "adafactor", "lion")


@dataclass(frozen=True)
class DataConfig:
    path: str = ""
    train_manifest: str = "train.tsv"
    train_labels: str = "train.wrd"
    val_manifest: str = "valid.tsv"
    val_labels: str = "valid.wrd"
    test_manifest: str = "test.tsv"
    test_labels: str = "test.wrd"
    batch_size: int = 8
    max_audio_length: int = 480_000     # 30 s @ 16 kHz
    max_video_length: int = 100
    max_label_length: int = 128
    num_workers: int = 2
    synthetic: bool = False
    synthetic_size: int = 100
    audio_buckets: tuple[int, ...] = (500, 1000, 1500)   # mel frames
    video_buckets: tuple[int, ...] = (25, 50, 100)       # video frames
    compact_transfer: bool = False
    specaugment: bool = False
    spec_time_masks: int = 2
    spec_time_width: int = 50
    spec_freq_masks: int = 2
    spec_freq_width: int = 12
    video_augment: bool = False
    vid_max_shift: int = 8
    vid_flip: bool = True
    vid_brightness: float = 0.1
    vid_contrast: float = 0.1


@dataclass(frozen=True)
class WhisperConfig:
    n_mels: int = 80
    d_model: int = 1024          # whisper-medium
    n_heads: int = 16
    n_layers: int = 24
    ffn_mult: int = 4
    max_frames: int = 3000       # 30 s of 10 ms hops

    @property
    def max_source_positions(self) -> int:
        return self.max_frames // 2  # conv2 stride-2


@dataclass(frozen=True)
class ClipConfig:
    image_size: int = 224
    patch_size: int = 32
    d_model: int = 768           # clip-vit-base-patch32
    n_heads: int = 12
    n_layers: int = 12
    ffn_mult: int = 4


@dataclass(frozen=True)
class LLMConfig:
    vocab_size: int = 128_256    # llama-3.2
    d_model: int = 2048          # llama-3.2-1B
    n_layers: int = 16
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_dim: int = 8192
    rope_theta: float = 500_000.0
    rms_eps: float = 1e-5
    tie_embeddings: bool = True
    max_seq_len: int = 2048
    moe_experts: int = 0
    moe_topk: int = 2
    moe_every: int = 1
    moe_capacity_factor: float = 1.25


@dataclass(frozen=True)
class LoRAConfig:
    use_lora: bool = True
    r: int = 16
    alpha: int = 32
    dropout: float = 0.05
    target_modules: tuple[str, ...] = ("q_proj", "k_proj", "v_proj", "o_proj")
    init_scale: float = 1.0


@dataclass(frozen=True)
class ModelConfig:
    llm_path: str = ""
    whisper_path: str = ""
    clip_path: str = ""
    audio_encoder_path: str = ""
    video_encoder_path: str = ""
    modality: str = "both"
    audio_encoder: str = "whisper"
    video_encoder: str = "clip"
    connector_type: str = "simple"
    fusion_scale: float = 0.5
    fusion_mode: str = "weighted_sum"
    max_seq_len: int = 512
    freeze_encoders: bool = True
    freeze_llm: bool = True
    use_4bit: bool = False
    use_8bit: bool = False
    prompt: str = "Transcribe the speech into text:"
    whisper: WhisperConfig = field(default_factory=WhisperConfig)
    clip: ClipConfig = field(default_factory=ClipConfig)
    llm: LLMConfig = field(default_factory=LLMConfig)
    lora: LoRAConfig = field(default_factory=LoRAConfig)
    unfreeze_layer_norms: bool = False
    finetune_avhubert_layers: tuple[int, ...] = ()
    connector_hidden_mult: int = 2
    qformer_queries: int = 32
    perceiver_latents: int = 64
    adapter_dim: int = 256
    num_adapter_layers: int = 2
    moe_experts: int = 8
    moe_topk: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    moe_z_weight: float = 1e-3

    @property
    def audio_dim(self) -> int:
        return self.whisper.d_model

    @property
    def video_dim(self) -> int:
        return self.clip.d_model

    @property
    def image_size(self) -> int:
        return self.clip.image_size


@dataclass(frozen=True)
class TrainingConfig:
    num_epochs: int = 10
    max_steps: int = -1                   # >0 overrides epochs
    auto_batch_size: bool = False
    learning_rate: float = 2e-5
    weight_decay: float = 0.01
    optimizer: str = "adamw"
    adam_b1: float = 0.9
    adam_b2: float = 0.95
    grad_accum_steps: int = 1
    max_grad_norm: float = 0.5
    warmup_steps: int = 100
    schedule: str = "cosine"              # cosine | linear | constant
    log_interval: int = 10
    save_every_steps: int = 1000
    save_every_secs: float = 7200.0
    keep_checkpoints: int = 3
    checkpoint_dir: str = "outputs/avsr"
    resume_from: str = ""
    seed: int = 42
    max_unstable_batches: int = 5
    loss_stability_window: int = 5
    eval_wer_every_epochs: int = 0
    eval_wer_max_utts: int = 32
    best_metric: str = "loss"
    early_stop_patience: int = 0


@dataclass(frozen=True)
class MeshConfig:
    dp: int = -1                 # -1: infer (one card here)
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    ep: int = 1
    pp: int = 1
    dcn_dp: int = 1
    axis_names: tuple[str, ...] = ("dcn", "dp", "fsdp", "ep", "sp", "tp", "pp")
    remat: bool = True           # torch.utils.checkpoint on LLM blocks
    donate: bool = True          # XLA buffer donation; no meaning here


@dataclass(frozen=True)
class RuntimeConfig:
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    debug_nans: bool = False
    profile_dir: str = ""
    use_pallas: str = "auto"            # auto | always | never (kernel dispatch)
    prng_impl: str = "rbg"
    compilation_cache_dir: str = "~/.cache/avsr_tpu_xla"


@dataclass(frozen=True)
class DecodeConfig:
    max_new_tokens: int = 100
    temperature: float = 0.0            # 0 => greedy
    top_p: float = 0.9
    num_beams: int = 1
    length_penalty: float = 1.0
    batch_size: int = 8
    output_dir: str = "outputs/decode"
    kv_cache_dtype: str = "bfloat16"
    lm_head_bits: int = 0
    stream_block_s: float = 0.0
    stream_video_fps: float = 25.0
    engine_slots: int = 0
    speculative: bool = False
    spec_gamma: int = 4
    spec_draft_bits: int = 8
    spec_draft_layers: int = 0
    spec_draft_checkpoint: str = ""
    spec_draft_config: str = ""


@dataclass(frozen=True)
class AVSRConfig:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)
    decode: DecodeConfig = field(default_factory=DecodeConfig)

    def validate(self) -> "AVSRConfig":
        m = self.model
        t = self.training
        if t.optimizer not in OPTIMIZERS:
            raise ValueError(
                "training.optimizer must be adamw | adafactor | lion, "
                f"got {t.optimizer!r}")
        if t.grad_accum_steps < 1:
            raise ValueError("grad_accum_steps must be >= 1")
        _check_ported(self)
        if m.modality not in MODALITIES:
            raise ValueError(
                f"modality must be one of {MODALITIES}, got {m.modality!r}")
        if m.connector_type not in CONNECTOR_TYPES:
            raise ValueError(
                f"connector_type must be one of {CONNECTOR_TYPES}, "
                f"got {m.connector_type!r}")
        if m.use_4bit and m.use_8bit:
            raise ValueError("use_4bit and use_8bit are mutually exclusive")
        if m.llm.n_heads % max(m.llm.n_kv_heads, 1) != 0:
            raise ValueError("llm.n_heads must be divisible by llm.n_kv_heads")
        for b, nxt in zip(self.data.audio_buckets, self.data.audio_buckets[1:]):
            if nxt <= b:
                raise ValueError("audio_buckets must be strictly increasing")
        if self.data.audio_buckets[-1] > m.whisper.max_frames:
            raise ValueError(
                f"largest audio bucket ({self.data.audio_buckets[-1]} mel "
                f"frames) exceeds whisper.max_frames ({m.whisper.max_frames})")
        if self.decode.lm_head_bits not in (0, 4, 8):
            raise ValueError("decode.lm_head_bits must be 0, 4 or 8")
        if self.decode.kv_cache_dtype not in ("bfloat16", "int8"):
            raise ValueError("decode.kv_cache_dtype must be bfloat16|int8")
        return self


def _check_ported(cfg: AVSRConfig) -> None:
    """Raises for knobs whose feature the port does not have yet."""
    mesh = cfg.mesh
    axes = {"dp": mesh.dp, "fsdp": mesh.fsdp, "tp": mesh.tp, "sp": mesh.sp,
            "ep": mesh.ep, "pp": mesh.pp, "dcn_dp": mesh.dcn_dp}
    wide = [f"mesh.{k}={v}" for k, v in axes.items() if v > 1]
    if wide:
        raise NotImplementedError(
            f"{', '.join(wide)}: the port runs on one card; multi-GPU "
            "layouts are not yet ported")
    off = {"training.optimizer": cfg.training.optimizer != "adamw",
           "training.auto_batch_size": cfg.training.auto_batch_size,
           "data.specaugment": cfg.data.specaugment,
           "data.video_augment": cfg.data.video_augment,
           "model.unfreeze_layer_norms": cfg.model.unfreeze_layer_norms}
    asked = [k for k, v in off.items() if v]
    if asked:
        raise NotImplementedError(
            f"{', '.join(asked)}: not yet ported to avsr_tpu_torch")


# ---------------------------------------------------------------------------
# Building from nested dicts, YAML and dotted overrides
# ---------------------------------------------------------------------------

def _coerce(value: Any, typ: Any) -> Any:
    """Coerce a YAML or command-line value into the dataclass field type."""
    if typing.get_origin(typ) is tuple:
        args = typing.get_args(typ)
        elem = args[0] if args else str
        if isinstance(value, str):
            value = [v for v in value.replace(",", " ").strip("[]()").split()
                     if v]
        elif not isinstance(value, (list, tuple)):
            value = [value]
        return tuple(_coerce(v, elem) for v in value)
    if typ is bool:
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return bool(value)
    if typ is int:
        return int(value)
    if typ is float:
        return float(value)
    if typ is str:
        return str(value)
    return value


def _build(cls: type, data: dict[str, Any] | None, path: str = "") -> Any:
    """Recursively build a dataclass from a nested dict, rejecting unknown keys."""
    kwargs: dict[str, Any] = {}
    known = {f.name: f for f in fields(cls)}
    hints = typing.get_type_hints(cls)
    for key, value in (data or {}).items():
        if key not in known:
            raise KeyError(f"Unknown config key {path + key!r} for {cls.__name__}")
        f = known[key]
        default = (f.default_factory() if f.default_factory is not dataclasses.MISSING
                   else f.default)
        if is_dataclass(default):
            if not isinstance(value, dict):
                raise TypeError(f"Config section {path + key!r} must be a mapping")
            kwargs[key] = _build(type(default), value, path=f"{path}{key}.")
        else:
            kwargs[key] = _coerce(value, hints[key])
    return cls(**kwargs)


def _set_dotted(tree: dict[str, Any], dotted: str, value: Any) -> None:
    parts = dotted.split(".")
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
        if not isinstance(node, dict):
            raise TypeError(f"Override {dotted!r} conflicts with scalar at {p!r}")
    node[parts[-1]] = value


def from_dict(tree: dict[str, Any],
              overrides: dict[str, Any] | list[str] | None = None) -> AVSRConfig:
    """Config from a nested dict plus dotted ``key=value`` overrides.

    Override values are strings coerced by the field's type, so no YAML
    parser is needed for them."""
    tree = {k: (dict(v) if isinstance(v, dict) else v) for k, v in tree.items()}
    if overrides:
        items = (overrides.items() if isinstance(overrides, dict)
                 else [_split_override(s) for s in overrides])
        for k, v in items:
            _set_dotted(tree, k, v)
    return _build(AVSRConfig, tree).validate()


def _split_override(s: str) -> tuple[str, str]:
    if "=" not in s:
        raise ValueError(f"Override {s!r} must be key=value")
    k, v = s.split("=", 1)
    return k.strip(), v.strip()


def to_dict(cfg: Any) -> dict[str, Any]:
    """The config as nested dicts of JSON types (tuples become lists), as
    the JAX package's ``to_dict`` gives it for a checkpoint's meta."""
    def clean(x: Any) -> Any:
        if isinstance(x, dict):
            return {k: clean(v) for k, v in x.items()}
        if isinstance(x, tuple):
            return list(x)
        return x

    return clean(dataclasses.asdict(cfg))


def load_config(yaml_path: str | Path | None = None,
                overrides: dict[str, Any] | list[str] | None = None) -> AVSRConfig:
    """Load a YAML config written for either package. CLI overrides win over
    YAML, which wins over defaults."""
    tree: dict[str, Any] = {}
    if yaml_path:
        import yaml

        with open(yaml_path) as fh:
            loaded = yaml.safe_load(fh) or {}
        if not isinstance(loaded, dict):
            raise TypeError(f"{yaml_path}: top level must be a mapping")
        tree = loaded
    return from_dict(tree, overrides)


def flagship(overrides: dict[str, Any] | list[str] | None = None) -> AVSRConfig:
    """The flagship config, a Python mirror of ``avsr_tpu/configs/base.yaml``
    (Whisper-medium + CLIP-B/32 + Llama-3.2-1B with LoRA r=16, modality
    ``both``, bf16 compute; AdamW with a cosine schedule, 4-step gradient
    accumulation and remat)."""
    tree = {
        "data": {
            "path": "", "batch_size": 8, "max_audio_length": 480000,
            "max_video_length": 100, "max_label_length": 128,
            "audio_buckets": [1000, 2000, 3000],
            "video_buckets": [25, 50, 100],
        },
        "model": {
            "modality": "both", "connector_type": "simple",
            "fusion_scale": 0.5, "fusion_mode": "weighted_sum",
            "max_seq_len": 1536, "freeze_encoders": True, "freeze_llm": True,
            "prompt": "Transcribe the speech into text:",
            "whisper": {"d_model": 1024, "n_heads": 16, "n_layers": 24,
                        "max_frames": 3000},
            "clip": {"image_size": 224, "patch_size": 32, "d_model": 768,
                     "n_heads": 12, "n_layers": 12},
            "llm": {"vocab_size": 128256, "d_model": 2048, "n_layers": 16,
                    "n_heads": 32, "n_kv_heads": 8, "ffn_dim": 8192,
                    "rope_theta": 500000.0},
            "lora": {"use_lora": True, "r": 16, "alpha": 32, "dropout": 0.05},
        },
        "training": {"num_epochs": 10, "learning_rate": 2.0e-5,
                     "grad_accum_steps": 4, "max_grad_norm": 0.5,
                     "warmup_steps": 100, "schedule": "cosine",
                     "checkpoint_dir": "outputs/avsr"},
        "mesh": {"dp": -1, "fsdp": 1, "tp": 1, "remat": True},
        "runtime": {"compute_dtype": "bfloat16"},
        "decode": {"max_new_tokens": 100, "temperature": 0.0, "num_beams": 1,
                   "batch_size": 8},
    }
    return from_dict(tree, overrides)

