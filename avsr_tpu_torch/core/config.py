"""Typed configuration of the PyTorch port.

A copy of the sections of ``avsr_tpu.core.config`` that the port reads
(``data``, ``model`` with its Whisper/HuBERT-Wav2Vec2/CLIP/LLM/LoRA subsections,
``training``, ``mesh``, ``runtime``, ``decode``), with the same field names
and defaults, so that a YAML file written for the JAX package loads here
unchanged. Mesh axes above 1 (multi-GPU layouts, not yet ported) raise
``NotImplementedError`` at validation rather than being ignored.
``mesh.donate`` is accepted and means nothing
here: it is an XLA buffer-donation hint, and eager PyTorch updates the
train state in place anyway.

PyYAML is imported only inside :func:`load_config`, for a file that is not
JSON: the two shipped configs are also built in Python, by :func:`flagship`
(``avsr_tpu/configs/base.yaml``) and :func:`hubert_base`
(``avsr_tpu/configs/hubert_base.yaml``), and :func:`save_config` writes
JSON, so both serve hosts without PyYAML.
"""

from __future__ import annotations

import dataclasses
import json
import typing
from dataclasses import dataclass, field, fields, is_dataclass
from pathlib import Path
from typing import Any

MODALITIES = ("audio", "video", "both")
CONNECTOR_TYPES = ("simple", "deep", "conv", "attention", "adaptive",
                   "cross_modal", "qformer", "perceiver", "adapter", "moe")
# the connectors that fuse audio and video themselves (modality "both" only)
DUAL_CONNECTORS = ("cross_modal", "qformer", "perceiver", "adapter")
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
class SpeechSSLConfig:
    """HuBERT / Wav2Vec2 audio-encoder geometry (HF facebook/hubert-*,
    facebook/wav2vec2-*), selected by ``model.audio_encoder``."""

    d_model: int = 768           # *-base; 1024 for *-large
    n_heads: int = 12
    n_layers: int = 12
    ffn_mult: int = 4
    conv_dims: tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_kernels: tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_strides: tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = False                  # True for *-large
    feat_extract_norm: str = "group"         # group (base) | layer (large)
    do_stable_layer_norm: bool = False       # pre-LN blocks (large)
    pos_conv_kernel: int = 128
    pos_conv_groups: int = 16
    sample_rate: int = 16000
    normalize_input: bool = True             # per-utterance zero-mean/unit-var

    @property
    def downsample(self) -> int:
        out = 1
        for s in self.conv_strides:
            out *= s
        return out


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
    ssl: SpeechSSLConfig = field(default_factory=SpeechSSLConfig)
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
        """Feature dim the audio connector consumes."""
        if self.audio_encoder == "whisper":
            return self.whisper.d_model
        return self.ssl.d_model

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
    remat: bool = True           # torch.utils.checkpoint on LLM and encoder blocks
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
        if m.connector_type in DUAL_CONNECTORS and m.modality != "both":
            raise ValueError(
                f"connector_type={m.connector_type!r} fuses audio+video and "
                f"requires modality='both' (got {m.modality!r})")
        if m.use_4bit and m.use_8bit:
            raise ValueError("use_4bit and use_8bit are mutually exclusive")
        if m.audio_encoder not in ("whisper", "hubert", "wav2vec2"):
            raise ValueError(
                f"audio_encoder must be whisper|hubert|wav2vec2, "
                f"got {m.audio_encoder!r}")
        if m.ssl.feat_extract_norm not in ("group", "layer"):
            raise ValueError("ssl.feat_extract_norm must be group|layer")
        if not (len(m.ssl.conv_dims) == len(m.ssl.conv_kernels)
                == len(m.ssl.conv_strides)):
            raise ValueError("ssl conv_dims/conv_kernels/conv_strides lengths differ")
        if m.llm.n_heads % max(m.llm.n_kv_heads, 1) != 0:
            raise ValueError("llm.n_heads must be divisible by llm.n_kv_heads")
        for b, nxt in zip(self.data.audio_buckets, self.data.audio_buckets[1:]):
            if nxt <= b:
                raise ValueError("audio_buckets must be strictly increasing")
        if (m.audio_encoder == "whisper"
                and self.data.audio_buckets[-1] > m.whisper.max_frames):
            raise ValueError(
                f"largest audio bucket ({self.data.audio_buckets[-1]} mel "
                f"frames) exceeds whisper.max_frames "
                f"({m.whisper.max_frames})")
        if self.decode.lm_head_bits not in (0, 4, 8):
            raise ValueError("decode.lm_head_bits must be 0, 4 or 8")
        if self.decode.kv_cache_dtype not in ("bfloat16", "int8"):
            raise ValueError("decode.kv_cache_dtype must be bfloat16|int8")
        _check_speculative(self)
        _check_serving(self)
        return self


def _check_speculative(cfg: AVSRConfig) -> None:
    """The JAX package's checks of the speculative-decoding knobs, message
    for message."""
    d, m = cfg.decode, cfg.model
    if (d.spec_draft_checkpoint or d.spec_draft_config) and not d.speculative:
        raise ValueError(
            "decode.spec_draft_checkpoint/spec_draft_config are set "
            "but decode.speculative is false — the trained draft "
            "would be silently ignored; add decode.speculative=true")
    if not d.speculative:
        return
    if d.num_beams > 1:
        raise ValueError(
            "decode.speculative requires num_beams=1 (greedy or "
            "sampled; beam search has its own decode loop)")
    if m.use_4bit or m.use_8bit:
        raise ValueError(
            "decode.speculative with a quantized target has no "
            "cheaper self-draft to build (spec_draft_bits IS the "
            "quantization); serve the bf16 target speculatively "
            "or the quantized target directly")
    if d.spec_draft_bits not in (4, 8):
        raise ValueError("decode.spec_draft_bits must be 4 or 8")
    if d.spec_gamma < 1:
        raise ValueError("decode.spec_gamma must be >= 1")
    if not 0 <= d.spec_draft_layers < m.llm.n_layers:
        raise ValueError(
            "decode.spec_draft_layers must be 0 (full-depth "
            "self-draft) or in [1, n_layers-1] — got "
            f"{d.spec_draft_layers} with {m.llm.n_layers} layers")
    if d.kv_cache_dtype != "bfloat16":
        raise ValueError(
            "decode.speculative needs kv_cache_dtype=bfloat16 "
            "(the verify pass extends a bf16 cache in place)")
    if d.engine_slots and d.temperature > 0:
        raise ValueError(
            "speculative serving (engine_slots + speculative) is "
            "greedy-only; set decode.temperature=0 or drop one "
            "of the two knobs")
    if bool(d.spec_draft_checkpoint) != bool(d.spec_draft_config):
        raise ValueError(
            "decode.spec_draft_checkpoint and "
            "decode.spec_draft_config come as a pair (the export "
            "dir and the draft's config.yaml — avsr-distill "
            "writes both)")
    if d.spec_draft_checkpoint:
        if d.spec_draft_layers:
            raise ValueError(
                "decode.spec_draft_checkpoint (separate trained "
                "draft) and spec_draft_layers (layer-skip "
                "self-draft) are mutually exclusive")
        if d.engine_slots:
            raise ValueError(
                "decode.spec_draft_checkpoint is standalone-decode "
                "only: engine slot caches assume the self/"
                "layer-skip draft geometry")


def _check_serving(cfg: AVSRConfig) -> None:
    """The JAX package's checks of the engine and streaming knobs, message
    for message."""
    d = cfg.decode
    if d.stream_block_s > 0 and d.stream_video_fps <= 0:
        raise ValueError(
            "decode.stream_video_fps must be > 0 (it sizes the "
            "video-frame block for blockwise streaming)")
    if d.engine_slots > 0 and d.num_beams > 1:
        raise ValueError(
            "decode.engine_slots (continuous batching) decodes slot by "
            "slot (greedy or per-request sampling) — incompatible with "
            "num_beams>1; use static batches for beam search")
    if d.stream_block_s > 0 and d.kv_cache_dtype == "int8":
        raise ValueError(
            "decode.stream_block_s (blockwise streaming) keeps a live "
            "float KV cache that is extended in place per block; "
            "int8 kv_cache_dtype quantizes once at prefill and is "
            "incompatible — use it with the exact mode only")


def _check_ported(cfg: AVSRConfig) -> None:
    """Raises for mesh axes above 1: the port runs on one card."""
    mesh = cfg.mesh
    axes = {"dp": mesh.dp, "fsdp": mesh.fsdp, "tp": mesh.tp, "sp": mesh.sp,
            "ep": mesh.ep, "pp": mesh.pp, "dcn_dp": mesh.dcn_dp}
    wide = [f"mesh.{k}={v}" for k, v in axes.items() if v > 1]
    if wide:
        raise NotImplementedError(
            f"{', '.join(wide)}: the port runs on one card; multi-GPU "
            "layouts are not yet ported")


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
    YAML, which wins over defaults. A file of JSON text (what
    :func:`save_config` writes) is read without PyYAML."""
    tree: dict[str, Any] = {}
    if yaml_path:
        text = Path(yaml_path).read_text()
        try:
            loaded = json.loads(text)
        except json.JSONDecodeError:
            import yaml

            loaded = yaml.safe_load(text) or {}
        if not isinstance(loaded, dict):
            raise TypeError(f"{yaml_path}: top level must be a mapping")
        tree = loaded
    return from_dict(tree, overrides)


def save_config(cfg: AVSRConfig, path: str | Path) -> None:
    """Write the resolved config as JSON text. JSON is YAML too, so the file
    may be called ``config.yaml`` and the JAX package's ``load_config``
    reads it, while this package's reads it on a host without PyYAML."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(to_dict(cfg), indent=1) + "\n")


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


def hubert_base(overrides: dict[str, Any] | list[str] | None = None) -> AVSRConfig:
    """The second shipped config, a Python mirror of
    ``avsr_tpu/configs/hubert_base.yaml``: HuBERT-base (12 post-LN layers of
    768, group-norm feature extractor, raw 16 kHz waveform in) +
    Llama-3.2-1B with LoRA r=16, audio only, bf16 compute. Set
    ``model.audio_encoder=wav2vec2`` for the same geometry under the
    Wav2Vec2 name."""
    tree = {
        "data": {"path": "", "batch_size": 8, "max_audio_length": 480000,
                 "max_label_length": 128, "audio_buckets": [1000, 2000, 3000]},
        "model": {
            "modality": "audio", "audio_encoder": "hubert",
            "connector_type": "simple", "max_seq_len": 1536,
            "freeze_encoders": True, "freeze_llm": True,
            "prompt": "Transcribe the speech into text:",
            "ssl": {"d_model": 768, "n_heads": 12, "n_layers": 12,
                    "feat_extract_norm": "group", "do_stable_layer_norm": False,
                    "conv_bias": False},
            "llm": {"vocab_size": 128256, "d_model": 2048, "n_layers": 16,
                    "n_heads": 32, "n_kv_heads": 8, "ffn_dim": 8192,
                    "rope_theta": 500000.0},
            "lora": {"use_lora": True, "r": 16, "alpha": 32},
        },
        "training": {"num_epochs": 10, "learning_rate": 2.0e-5,
                     "grad_accum_steps": 4, "max_grad_norm": 0.5,
                     "warmup_steps": 100, "checkpoint_dir": "outputs/avsr_hubert"},
        "runtime": {"compute_dtype": "bfloat16"},
    }
    return from_dict(tree, overrides)
