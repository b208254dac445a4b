"""avsr_tpu_torch — the PyTorch/CUDA port of avsr_tpu for NVIDIA Hopper.

A second package beside the JAX reference: the same parameter trees (nested
dicts of tensors with the JAX key paths), the same public layouts, and
hand-written CUDA kernels where the JAX package has Pallas kernels.

Layering (bottom-up):
    core/    typed config (a copy of the JAX schema), the trainer's metric logs
    csrc/    CUDA C++ kernels, built with nvcc at first use (ops/_build.py)
    ops/     flash-attention forward and backward (kernels + plain versions,
             the autograd Function), int8/int4 weight-only quantization and
             its decode-shape matmul kernels (QDot under autograd), log-mel,
             frames, SpecAugment, video augmentation
    models/  Whisper encoder, CLIP ViT, simple connector, Llama + LoRA
             (dropout, remat, quantized base, fused decode layout, int8 KV
             cache), AVSR (encode, prefix, training forward)
    data/    byte tokenizer, synthetic dataset, collate + featurize, DataLoader
    infer/   prefill + KV-cache greedy/sampled generation, WER
    train/   masks, AdamW / adafactor / lion + schedules, train/eval steps,
             the Trainer, checkpoints, the batch-size probe
    cli/     decode, train (with the --mode presets) and average entry points
"""

__version__ = "0.1.0"
