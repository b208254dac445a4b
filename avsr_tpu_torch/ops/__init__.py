"""Ops: attention and its kernels, frames, log-mel, quantized products and
the rest. Kernels are built and loaded when first launched, so importing
this needs neither CUDA nor triton.

It re-exports the names ``avsr_tpu.ops`` re-exports but one: there,
``attention`` is the function; here it stays the module
``avsr_tpu_torch.ops.attention`` (whose ``attention`` is the function),
because the kernel wrappers' launch counters are read from the module as
``ops.attention.launches``, and a function of that name in this namespace
would shadow it."""

from avsr_tpu_torch.ops.attention import flash_attention, mha_reference  # noqa: F401
from avsr_tpu_torch.ops.image import preprocess_frames, sample_frame_indices  # noqa: F401
from avsr_tpu_torch.ops.logmel import log_mel_spectrogram, mel_filterbank  # noqa: F401
