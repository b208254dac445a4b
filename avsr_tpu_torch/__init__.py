"""avsr_tpu_torch — the PyTorch/CUDA port of avsr_tpu for NVIDIA Hopper.

A second package beside the JAX reference: the same parameter trees (nested
dicts of tensors with the JAX key paths), the same public layouts, and
hand-written CUDA kernels where the JAX package has Pallas kernels.

Layering (bottom-up):
    core/    typed config (a copy of the JAX schema), logging and the trainer's
             metric logs, the runtime settings
    csrc/    CUDA C++ kernels, built with nvcc at first use (ops/_build.py)
    ops/     flash-attention forward and backward (kernels + plain versions,
             the autograd Function), int8/int4 weight-only quantization and
             its decode-shape matmul kernels (QDot under autograd), log-mel,
             frames under each encoder's image statistics (and the compact
             link's YUV420), SpecAugment, video
             augmentation
    models/  Whisper and HuBERT/Wav2Vec2 encoders, the CLIP ViT, ResNet,
             EfficientNet and AV-HuBERT video encoders, connectors, Llama + LoRA
             (dropout, remat, quantized base, fused decode layout, int8 KV
             cache), AVSR (encode, prefix, training forward)
    data/    byte and HF tokenizers, manifests, the manifest and synthetic
             datasets, collate + featurize (and the compact link), the
             threaded DataLoader, WAV/frame readers
    native/  the C++ host library of the data path (batch WAV decode,
             resize, YUV420), built with g++ at first use
    infer/   prefill + KV-cache greedy/sampled/beam/speculative generation,
             the serving engine, the server, streaming, WER
    train/   masks, AdamW / adafactor / lion + schedules, train/eval steps,
             the Trainer, checkpoints, the batch-size probe
    cli/     decode, train (with the --mode presets), average, distill, serve,
             stream, infer, prepare_data, convert_hf and convert_ref_ckpt entry
             points
"""

__version__ = "0.1.0"
