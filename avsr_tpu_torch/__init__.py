"""avsr_tpu_torch — the PyTorch/CUDA port of avsr_tpu for NVIDIA Hopper.

A second package beside the JAX reference: the same parameter trees (nested
dicts of tensors with the JAX key paths), the same public layouts, and
hand-written CUDA kernels where the JAX package has Pallas kernels.

Layering (bottom-up):
    core/    typed config (a copy of the serving sections of the JAX schema)
    csrc/    CUDA C++ kernels, built with nvcc at first use (ops/_build.py)
    ops/     flash-attention forward (kernel + plain version), log-mel, frames
    models/  Whisper encoder, CLIP ViT, simple connector, Llama + LoRA, AVSR
    data/    byte tokenizer, synthetic dataset, collate + on-device featurize
    infer/   prefill + KV-cache greedy/sampled generation, WER
    cli/     decode entry point
"""

__version__ = "0.1.0"
