"""The start-up batch-size probe (``training.auto_batch_size``), the port of
``avsr_tpu/train/probe.py``.

It probes the worst case: one whole train step (forward, backward and
update) on a synthetic batch at the largest configured (audio, video)
bucket pair and the longest labels; if that fits, every real batch fits.
The size doubles from ``start`` until a step runs out of device memory
(``torch.cuda.OutOfMemoryError``) or passes ``max_batch``, and the probe
returns the largest size that ran (0 if even ``start`` did not). Any other
error propagates.

The optimizer updates the parameters in place, so the caller hands the
probe a parameter tree of its own (the train CLI makes a second init and
drops it afterwards, as the JAX CLI does).

Under a mesh (JAX ``probe.py:77``) the size is the global batch, from the
data-parallel ways up (``ep`` is one of them), and each rank probes its own
share: its rows and, under fsdp, tp or ep, its slices of the sharded
leaves, over groups that gather, exchange and reduce locally
(``Mesh.echo``). So a rank that runs out of memory never
leaves the others waiting in a collective; at the end every rank takes
the smallest size any rank found. Under ``mesh.pp`` every size it tries
is a multiple of the stages too (JAX's pipeline check: the global batch
divides into ``pp`` microbatches), where JAX's probe starts at the data
ways and raises that check's message when ``pp`` does not divide them.
"""

from __future__ import annotations

import gc
import logging
import math

import torch

from avsr_tpu_torch.core.config import AVSRConfig
from avsr_tpu_torch.models.avsr import Batch

log = logging.getLogger("avsr_tpu_torch.probe")


def _worst_case_batch(cfg: AVSRConfig, b: int, device: str | torch.device,
                      seed: int = 0) -> Batch:
    """A largest-bucket synthetic batch of ``b`` utterances, made on the
    device (it never touches real data): the JAX batch's shapes and
    dtypes, random values."""
    m = cfg.model
    gen = torch.Generator(device=device).manual_seed(seed)
    mel_T = min(cfg.data.audio_buckets[-1], m.whisper.max_frames)
    vid_T = cfg.data.video_buckets[-1]
    Tl = cfg.data.max_label_length
    dt = getattr(torch, cfg.runtime.compute_dtype)
    audio = m.modality in ("audio", "both")
    video = m.modality in ("video", "both")
    hi = min(m.llm.vocab_size, 1000)

    def full(n: int) -> torch.Tensor:
        return torch.full((b,), n, dtype=torch.int32, device=device)

    def ints(shape: tuple[int, ...]) -> torch.Tensor:
        return torch.randint(0, hi, shape, generator=gen, device=device,
                             dtype=torch.int32)

    return Batch(
        mel=(torch.randn((b, m.whisper.n_mels, mel_T), generator=gen,
                         device=device) if audio else None),
        mel_lens=full(mel_T) if audio else None,
        frames=(torch.randn((b, vid_T, 3, m.image_size, m.image_size),
                            generator=gen, device=device).to(dt)
                if video else None),
        frame_lens=full(vid_T) if video else None,
        prompt_tokens=ints((b, 8)),
        labels=ints((b, Tl)),
        label_lens=full(Tl),
    )


def _fits(cfg: AVSRConfig, params, b: int, device, mesh=None) -> bool:
    """Whether one train step at batch ``b`` (this rank's rows) runs. Every
    tensor of the step is local to this frame, so it is free to collect
    once this returns."""
    from avsr_tpu_torch.mesh.sharding import shard_params
    from avsr_tpu_torch.train.state import create_train_state
    from avsr_tpu_torch.train.step import make_train_step, microbatch

    try:
        step = make_train_step(cfg, mesh)
        if mesh is not None:
            params = shard_params(params, mesh)
        state = create_train_state(params, cfg, total_steps=2)
        batch = microbatch(_worst_case_batch(cfg, b, device), 1)
        step(state, batch, 0)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        return True
    except torch.cuda.OutOfMemoryError:
        # the exception's traceback holds the failed step's frames and
        # their tensors: it goes when this handler ends
        return False


def find_optimal_batch_size(cfg: AVSRConfig, params, *, start: int = 1,
                            max_batch: int = 512,
                            device: str | torch.device = "cuda", mesh=None) -> int:
    """Doubling probe; the largest (global) batch whose worst-case train
    step runs, 0 if even ``start`` (rounded up to a multiple of the mesh's
    data-parallel ways and pipeline stages) runs out of memory."""
    ways = mesh.ways if mesh is not None else 1
    echo = mesh.echo() if mesh is not None else None
    grain = math.lcm(ways, mesh.shape["pp"]) if mesh is not None else 1
    b, best = -(-max(start, ways) // grain) * grain, 0
    while b <= max_batch:
        ok = _fits(cfg, params, b // ways, device, echo)
        gc.collect()            # the failed step's frames form cycles
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        if not ok:
            log.info("batch probe: %d runs out of memory, stopping", b)
            break
        log.info("batch probe: %d fits", b)
        best = b
        b *= 2
    if mesh is not None:
        best = int(mesh.world.all_reduce(torch.tensor([float(best)], device=device),
                                         op="min").item())
    return best
