"""Continuous-batching serving engine, the port of ``avsr_tpu/infer/engine.py``.

Static batches decode until their LAST row finishes, so ragged transcript
lengths leave most rows idle (head-of-line blocking). The engine readmits
new requests into finished rows mid-flight:

  * one persistent KV cache of S slots, ``[L, S, Hkv, M, Dh]``
    (``models/llama.py::KVCache``), mutated in place;
  * ``stage`` — encode a full group of queued requests and prefill their
    [prompt][features] prefixes into full-width (M) cache rows, independent
    of slot availability, so the encoder and prefill run at the staging
    width however raggedly slots free up;
  * ``install`` — the slot-dependent tail of admission: copy staged rows
    into free pool slots (no model compute);
  * ``decode_chunk`` — k single-token steps over ALL slots, greedy or
    per-slot temperature/top-p; finished slots idle behind ``done``;
  * the host loop in :class:`ServingEngine` refills finished slots from
    staged rows between chunks, staging ahead.

Each row's numbers are independent of the other slots (row-batched
products, per-row masked attention), so each request's transcript equals a
standalone ``generate_tokens`` call (``tests/test_torch_engine.py``).

Multi-tenant LoRA (``adapter_bank=`` + ``submit(adapter=k)``): per-request
bank rows are gathered per stage and per chunk and applied row by row
(``infer/adapters.py``), so tenants mix freely in the pool.

What differs from the JAX package, and why:

  * The JAX chunk is a ``while_loop`` that exits once every slot is done.
    Here the chunk runs the k steps the host picked (``_pick_k``) without
    reading ``done`` on the host; the device counts the steps taken while
    some slot was still active, which is what ``stats()`` reports, as the
    JAX loop's early exit does. Finished slots emit ``eos_id`` and keep
    their frontier, so the tokens do not change; steps past the last
    finish are paid for and wasted.
  * The JAX engine fetches each chunk's tokens on a thread, with
    ``device_get``. Here each chunk's tokens and step count (and its
    admissions' first tokens) are copied into pinned host memory with
    ``non_blocking=True`` behind a recorded ``torch.cuda.Event``, and the
    scheduler absorbs them once the event has passed, ``pipeline_depth``
    chunks behind (``_Fetcher``). On the CPU the fetch is synchronous.
  * The slot cache is updated in place (``install`` copies rows in;
    decode steps write at ``cur_lens``) where JAX donates it.
  * Sampling draws Gumbel noise from a ``torch.Generator``
    (:func:`slot_noise`); :func:`_slot_sample` applies it deterministically
    (JAX's ``categorical`` is argmax(logits + Gumbel)).

Threads: the prep worker collates on a host thread and hands back host
arrays; the device copy and featurization happen on the thread that owns
the engine, which is the only thread that touches its tensors. ``warmup``
makes the engine's first launches on that thread (the qmatmul split
workspaces live per (device, stream)).
"""

from __future__ import annotations

import functools
import queue
import threading
from collections import deque
from dataclasses import dataclass, replace

import numpy as np
import torch

from avsr_tpu_torch.core.config import AVSRConfig, DataConfig, ModelConfig
from avsr_tpu_torch.data.audio_io import load_audio
from avsr_tpu_torch.data.dataset import Sample
from avsr_tpu_torch.data.loader import HostBatch, collate, featurize, pick_bucket
from avsr_tpu_torch.infer import adapters as ad
from avsr_tpu_torch.infer.generate import _top_p_filter
from avsr_tpu_torch.models import llama as L
from avsr_tpu_torch.models.avsr import Batch, build_prefix, encode
from avsr_tpu_torch.models.layers import Params
from avsr_tpu_torch.ops.logmel import HOP_LENGTH


def collate_group(samples: list[Sample], cfg: DataConfig, prompt_ids: list[int],
                  pad_id: int) -> HostBatch:
    """A request group's host batch (host work only: the prep thread runs
    it). A manifest dataset's sample whose WAV decode was deferred to the
    batch loader (``audio_path``) is decoded here, so the engine admits
    samples straight from the dataset; with ``data.compact_transfer`` the
    batch is packed in the compact link format, which ``featurize`` unpacks
    on the device."""
    samples = [replace(s, audio=load_audio(s.audio_path, max_samples=cfg.max_audio_length))
               if s.audio is None and s.audio_path else s for s in samples]
    return collate(samples, cfg, prompt_ids, pad_id)


def slot_noise(S: int, V: int, generator: torch.Generator,
               device: torch.device) -> torch.Tensor:
    """The randomness of one :func:`_slot_sample`: standard Gumbel noise
    [S, V] f32, -log(-log(u)) with u uniform in (0, 1)."""
    u = torch.rand((S, V), generator=generator, device=device)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp(min=tiny)))


def _slot_sample(logits: torch.Tensor, temps: torch.Tensor, top_ps: torch.Tensor,
                 noise: torch.Tensor) -> torch.Tensor:
    """Per-row greedy-or-nucleus next token: rows with temperature <= 0
    take argmax, the rest sample from the top-p filtered distribution at
    their own temperature, given the draw ``noise`` (:func:`slot_noise`).
    logits [S, V] f32, temps/top_ps [S] -> [S]."""
    greedy = torch.argmax(logits, dim=-1)
    scaled = logits / temps.clamp(min=1e-6)[:, None]
    filtered = _top_p_filter(scaled, top_ps[:, None])
    sampled = torch.argmax(filtered + noise, dim=-1)
    return torch.where(temps <= 0.0, greedy, sampled)


def _with_bank(llm: Params, adapters: Params | None,
               adapter_ids: torch.Tensor | None) -> Params:
    """The LLM tree with each row's adapter grafted on (a bank), or as it
    is (none)."""
    if adapters is None:
        return llm
    return ad.inject_lora(llm, ad.select_lora(adapters, adapter_ids))


@torch.inference_mode()
def stage(params: Params, model_cfg: ModelConfig, batch: Batch,
          temps: torch.Tensor, top_ps: torch.Tensor,
          generator: torch.Generator | None = None,
          adapters: Params | None = None, adapter_ids: torch.Tensor | None = None,
          *, cache_len: int, quantize: bool = False, sampling: bool = False,
          compute_dtype: torch.dtype = torch.bfloat16, use_kernel: str = "auto"
          ) -> tuple[L.KVCache, torch.Tensor, torch.Tensor]:
    """Prefill stage, decoupled from slot availability: encode a media
    batch of W requests and run the [prompt][features] prefixes through the
    LLM into full-width (``cache_len`` = M) cache rows. Returns (rows
    [L, W, Hkv, M, Dh], first tokens [W], prefix lengths [W]). ``quantize``
    gives the rows of an int8 slot cache (``quantize_cache``: per-(layer,
    row, kv head) scales, the static int8 path's math); ``sampling`` draws
    the sampled rows' first tokens with noise from ``generator``."""
    dt = compute_dtype
    cfg = model_cfg.llm
    llm = _with_bank(params["llm"], adapters, adapter_ids)
    enc = encode(params, model_cfg, batch, compute_dtype=dt, use_kernel=use_kernel,
                 moe_rowwise=True)
    prefix, plens = build_prefix(params, model_cfg, batch, enc, compute_dtype=dt)
    hidden, rows = L.llama_apply(
        llm, cfg, inputs_embeds=prefix, lengths=plens,
        lora=model_cfg.lora if model_cfg.lora.use_lora else None,
        compute_dtype=dt, use_kernel=use_kernel, return_cache=True,
        cache_len=cache_len, output="hidden", moe_rowwise=True)
    W = prefix.shape[0]
    h_last = hidden[torch.arange(W, device=hidden.device), plens.long() - 1][:, None]
    logits = L.compute_logits(llm, cfg, h_last, use_kernel)[:, 0]
    if sampling:
        noise = slot_noise(W, logits.shape[-1], generator, logits.device)
        tok0 = _slot_sample(logits.float(), temps, top_ps, noise)
    else:
        tok0 = torch.argmax(logits, dim=-1)
    if quantize:
        rows = L.quantize_cache(rows)
    return rows, tok0, plens.long()


@torch.inference_mode()
def install_rows(cache: L.KVCache, rows: L.KVCache, idxs: torch.Tensor,
                 slots: torch.Tensor) -> None:
    """Copy staged rows ``idxs`` into pool ``slots`` of ``cache``, in place
    (the int8 cache's per-slot scales ride along). The draft cache of
    speculative serving installs through this alone."""
    cache.k[:, slots] = rows.k[:, idxs]
    cache.v[:, slots] = rows.v[:, idxs]
    if rows.quantized:
        cache.k_scale[:, slots] = rows.k_scale[:, idxs]
        cache.v_scale[:, slots] = rows.v_scale[:, idxs]


@torch.inference_mode()
def install(cache: L.KVCache, rows: L.KVCache, idxs: torch.Tensor,
            slots: torch.Tensor, cur_lens: torch.Tensor, last_tok: torch.Tensor,
            done: torch.Tensor, rem: torch.Tensor, budgets: torch.Tensor,
            tok0: torch.Tensor, plens: torch.Tensor, *, eos_id: int = 2
            ) -> torch.Tensor:
    """The slot-dependent tail of admission: copy staged rows into free
    pool slots and set those slots' state (frontier, last token, done,
    remaining budget), all in place; no model compute. Returns the first
    tokens of the installed requests [G]."""
    install_rows(cache, rows, idxs, slots)
    t0 = tok0[idxs]
    cur_lens[slots] = plens[idxs]
    last_tok[slots] = t0
    done[slots] = (t0 == eos_id) | (budgets <= 1)
    # tok0 already consumed one budget unit (it came from the prefill)
    rem[slots] = (budgets - 1).clamp(min=0)
    return t0


@torch.inference_mode()
def decode_chunk(params: Params, model_cfg: ModelConfig, cache: L.KVCache,
                 cur_lens: torch.Tensor, last_tok: torch.Tensor, done: torch.Tensor,
                 rem: torch.Tensor, k: int, temps: torch.Tensor | None = None,
                 top_ps: torch.Tensor | None = None,
                 generator: torch.Generator | None = None,
                 adapters: Params | None = None,
                 adapter_ids: torch.Tensor | None = None, *, k_max: int = 64,
                 eos_id: int = 2, sampling: bool = False,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 use_kernel: str = "auto") -> tuple[torch.Tensor, torch.Tensor]:
    """``k`` (<= ``k_max``) decode steps over all S slots, greedy or (with
    ``sampling``) per-slot greedy-or-nucleus. The slot state (``cache``,
    ``cur_lens``, ``last_tok``, ``done``, ``rem``) is updated in place and
    never read on the host: a slot freezes (done) at EOS or when its
    budget ``rem`` is spent; finished slots emit ``eos_id`` and keep their
    frontier (their writes land at a frozen position that the next
    install overwrites). Returns (tokens [S, k_max], eos-padded past step
    k; steps run, a device scalar: the steps taken while some slot was
    still active, which the JAX loop's early exit would have run)."""
    dt = compute_dtype
    cfg = model_cfg.llm
    lora = model_cfg.lora if model_cfg.lora.use_lora else None
    S = cur_lens.shape[0]
    llm = _with_bank(params["llm"], adapters, adapter_ids)
    out = torch.full((S, k_max), eos_id, dtype=torch.int64, device=cur_lens.device)
    steps = torch.zeros((), dtype=torch.int64, device=cur_lens.device)
    for j in range(k):
        steps += (~done).any()
        emb = L.embed_tokens(llm, last_tok[:, None], dt)
        logits, _ = L.llama_decode_step(llm, cfg, x=emb, cache=cache, cur_lens=cur_lens,
                                        lora=lora, compute_dtype=dt, use_kernel=use_kernel)
        if sampling:
            noise = slot_noise(S, logits.shape[-1], generator, logits.device)
            pick = _slot_sample(logits.float(), temps, top_ps, noise)
        else:
            pick = torch.argmax(logits, dim=-1)
        nxt = torch.where(done, eos_id, pick)
        out[:, j] = nxt
        active = (~done).long()
        cur_lens += active
        rem -= active
        done |= (nxt == eos_id) | (rem <= 0)
        last_tok.copy_(nxt)
    return out, steps


@torch.inference_mode()
def decode_chunk_spec(params: Params, draft_params: Params, model_cfg: ModelConfig,
                      cache: L.KVCache, d_cache: L.KVCache, cur_lens: torch.Tensor,
                      last_tok: torch.Tensor, prev_tok: torch.Tensor,
                      gap: torch.Tensor, fresh: torch.Tensor, done: torch.Tensor, *,
                      k_rounds: int = 4, gamma: int = 4, eos_id: int = 2,
                      compute_dtype: torch.dtype = torch.bfloat16,
                      use_kernel: str = "auto",
                      draft_model_cfg: ModelConfig | None = None):
    """``k_rounds`` speculative rounds over all S slots (greedy only): each
    round drafts ``gamma`` tokens per slot with the draft, verifies them in
    ONE [S, gamma+1] target pass (``llama_prefill_continue``) and accepts
    the longest argmax-matching prefix plus the target's bonus token, per
    slot; token for token the greedy chunk (budgets and EOS truncation stay
    on the host, as in :func:`decode_chunk`). ``cur_lens`` is the slot
    frontier (P + n - 1), ``last_tok`` e_{n-1}, ``prev_tok`` e_{n-2} and
    ``gap`` (1 or 2) the tail the draft cache lacks; ``fresh`` marks slots
    admitted since the last chunk.

    The caches are written in place. Returns (cur_lens, last_tok, prev_tok,
    gap, done, tokens [S, k_rounds*(gamma+1)] eos-padded, n_new [S] valid
    counts, the slot-rounds verified for a slot not yet done (a device
    scalar), the draft steps launched). Done and idle slots keep re-verifying at a frozen frontier
    into rows that ``install`` overwrites. A slot running past its budget
    inside the chunk (its extra tokens are dropped on the host) could
    reach the cache's last column: its write positions are clamped to the
    cache, which no position of a token within budget reaches. Whether a
    round needs the catch-up draft step is read on the host once per
    round."""
    dt = compute_dtype
    cfg = model_cfg.llm
    dcfg = (draft_model_cfg or model_cfg).llm
    lora = model_cfg.lora if model_cfg.lora.use_lora else None
    S = cur_lens.shape[0]
    dev = cur_lens.device
    G = gamma
    cap = k_rounds * (G + 1)
    top = cache.k.shape[3] - (G + 1)
    llm, dllm = params["llm"], draft_params["llm"]
    cur, last, done = cur_lens.clone(), last_tok.clone(), done.clone()
    # admitted slots start with only e0 pending for the draft
    prev = torch.where(fresh, last, prev_tok)
    gap = torch.where(fresh, 1, gap)
    out = torch.full((S, cap), eos_id, dtype=torch.int64, device=dev)
    cpos = torch.zeros((S,), dtype=torch.int64, device=dev)
    j = torch.arange(G + 1, device=dev)[None, :]
    rows = torch.arange(S, device=dev)
    live = torch.zeros((), dtype=torch.int64, device=dev)
    n_draft = 0

    def draft_step(tok: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        nonlocal n_draft
        n_draft += 1
        return L.llama_decode_step(dllm, dcfg, x=L.embed_tokens(dllm, tok[:, None], dt),
                                   cache=d_cache, cur_lens=pos, compute_dtype=dt,
                                   use_kernel=use_kernel)[0]

    for _ in range(k_rounds):
        live += (~done).sum()
        base = cur.clamp(max=top)
        # draft catch-up of the <= 2 pending tail tokens; with gap 1 step A
        # rewrites step B's position as it is, so it runs only when some
        # slot has gap 2
        if bool((gap == 2).any()):
            draft_step(torch.where(gap == 2, prev, last),
                       torch.where(gap == 2, base - 1, base).clamp(min=0))
        dlog = draft_step(last, base)
        drafts = []
        for i in range(G):
            tok = torch.argmax(dlog, dim=-1)
            drafts.append(tok)
            dlog = draft_step(tok, base + 1 + i)
        drafts = torch.stack(drafts, dim=1)                        # [S, G]

        # verify: one target pass over [e_{n-1}, d_1 .. d_G]
        ver = torch.cat([last[:, None], drafts], dim=1)
        vh, _ = L.llama_prefill_continue(
            llm, cfg, x=L.embed_tokens(llm, ver, dt), cache=cache, base_lens=base,
            tail_lens=torch.full((S,), G + 1, dtype=torch.int64, device=dev),
            lora=lora, compute_dtype=dt, use_kernel=use_kernel)
        a = torch.argmax(L.compute_logits(llm, cfg, vh, use_kernel), dim=-1)  # [S, G+1]

        # accept the longest matching prefix + the bonus token
        m = torch.cumprod((drafts == a[:, :G]).int(), dim=1).sum(dim=1)
        cand_ok = j <= m[:, None]
        hit_eos = ((a == eos_id) & cand_ok).int()
        emit = cand_ok & (torch.cumsum(hit_eos, dim=1) - hit_eos == 0) & ~done[:, None]
        n_emit = emit.sum(dim=1)
        idx = (cpos[:, None] + j).clamp(0, cap - 1)
        out[rows[:, None], idx] = torch.where(emit, a, out.gather(1, idx))
        last_new = torch.where(
            n_emit > 0, a.gather(1, (n_emit - 1).clamp(min=0)[:, None])[:, 0], last)
        prev = torch.where(
            n_emit >= 2, a.gather(1, (n_emit - 2).clamp(min=0)[:, None])[:, 0],
            torch.where(n_emit == 1, last, prev))
        last = last_new
        done = done | (emit & (a == eos_id)).any(dim=1)
        gap = torch.where(done, gap, torch.where(n_emit == G + 1, 2, 1))
        cur = cur + n_emit
        cpos = cpos + n_emit
    return cur, last, prev, gap, done, out, cpos, live, n_draft


@torch.inference_mode()
def mask_done(done: torch.Tensor, rem: torch.Tensor, mask: torch.Tensor) -> None:
    """Force slots done (host-side cancels), in place: queued on the
    device between the chunks around it, so a cancelled request stops
    decoding without waiting for its chunk to be fetched."""
    done |= mask
    rem.masked_fill_(mask, 0)


@dataclass
class _Slot:
    req: int | None = None         # request index, None = free
    tokens: list | None = None     # generated ids so far (incl. first)
    budget: int = 0


@dataclass
class _Req:
    """Host bookkeeping for one request (pipelined schedule). Tokens
    arrive at chunk FETCH time, routed by the per-chunk (slot, req)
    snapshot — a slot may already host a successor request by then."""

    tokens: list
    budget: int
    finished: bool = False


@dataclass
class _Chunk:
    """A dispatched-but-unfetched decode chunk. ``admits`` carries the
    installs dispatched just before it (their first tokens ride the same
    fetch); ``snap`` maps slots to the requests resident at dispatch."""

    out: torch.Tensor              # [S, k_max] device
    steps: torch.Tensor            # scalar device — steps actually run
    k: int                         # steps requested
    snap: list                     # [(slot, req_id)]
    admits: list                   # [(group meta, tok0 on the device)]


class _Fetcher:
    """Chunk outputs to the host without blocking the scheduler: each
    chunk's tokens, step count and admissions' first tokens are copied
    into pinned host buffers of their own (``non_blocking``) behind a
    recorded CUDA event, and come back in submit order once the event has
    passed. CPU tensors are read as they are (the chunk already ran)."""

    def __init__(self) -> None:
        self._q: deque = deque()

    def submit(self, chunk: _Chunk) -> None:
        tensors = [chunk.out, chunk.steps.reshape(1)] + [t for _, t in chunk.admits]
        event = None
        if chunk.out.is_cuda:
            host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
            for h, t in zip(host, tensors):
                h.copy_(t, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            host = tensors
        self._q.append((chunk, host, event))

    def done(self, block: bool = False):
        """Next (chunk, (out, steps, admit tok0s)) in submit order as numpy
        and int, or None when the next one has not arrived (or nothing is
        in flight)."""
        if not self._q:
            return None
        chunk, host, event = self._q[0]
        if event is not None:
            if block:
                event.synchronize()
            elif not event.query():
                return None
        self._q.popleft()
        return chunk, (host[0].numpy(), int(host[1][0]), [h.numpy() for h in host[2:]])

    def close(self) -> None:
        self._q.clear()


class _PrepWorker:
    """One background thread that collates admission groups (host arrays
    only) so the scheduler thread never blocks on host prep; the device
    copy and featurization happen on the scheduler thread."""

    def __init__(self, prep_fn):
        self._in: queue.Queue = queue.Queue()
        self._out: queue.Queue = queue.Queue()
        self._fn = prep_fn
        self._th = threading.Thread(target=self._run, daemon=True)
        self._th.start()

    def submit(self, group: list) -> None:
        self._in.put(group)

    def _run(self) -> None:
        while True:
            group = self._in.get()
            if group is None:
                return
            try:
                self._out.put((group, self._fn([s for _, s, *_ in group]), None))
            except Exception as e:      # noqa: BLE001 — surfaced to caller
                self._out.put((group, None, e))

    def ready(self, block: bool = False):
        """Next (group, host batch) or None; re-raises prep errors."""
        try:
            group, hb, err = self._out.get(block)
        except queue.Empty:
            return None
        if err is not None:
            raise err
        return group, hb

    def close(self) -> None:
        self._in.put(None)


@dataclass
class _Staged:
    """A prefilled batch waiting for pool slots. ``meta`` entries are
    (req, budget, temperature, top_p, adapter); rows/tok0/plens live on
    the device."""
    meta: list
    rows: L.KVCache
    tok0: torch.Tensor
    plens: torch.Tensor
    next: int = 0                  # first unconsumed row
    d_rows: L.KVCache | None = None    # draft prefill rows (spec mode)

    @property
    def remaining(self) -> int:
        return len(self.meta) - self.next


class ServingEngine:
    """Continuous batching over a fixed pool of S slots.

    Online interface: :meth:`submit` enqueues a request (with its own
    budget/temperature/top_p/adapter) at any time — including while
    earlier requests are mid-decode — and :meth:`step` advances the pool by
    one schedule iteration, returning whichever requests finished.
    Offline: :meth:`transcribe` submits a whole list and steps until done,
    returning generated ids in input order (EOS included, as
    ``generate_tokens`` reports lengths). Short utterances leave early,
    long ones keep their slot, the batch never drains to refill.

    The engine is not thread-safe: one thread owns it (the server's
    scheduler thread), and that thread alone touches its tensors.
    """

    def __init__(self, params: Params, cfg: AVSRConfig, tok, *,
                 num_slots: int = 8, max_new_tokens: int | None = None,
                 k_steps: int = 16, cache_len: int | None = None,
                 seed: int = 0, adapter_bank: Params | None = None,
                 draft_params: Params | None = None, spec_gamma: int = 0,
                 spec_rounds: int = 4, admission: str = "budget",
                 draft_model_cfg: ModelConfig | None = None, pipeline_depth: int = 2):
        self.params = params
        self.cfg = cfg
        self.tok = tok
        self.S = num_slots
        self.device = params["llm"]["embed"].device
        self.dt = getattr(torch, cfg.runtime.compute_dtype)
        self.use_kernel = cfg.runtime.use_pallas
        # admission="budget" packs each staging group around the longest
        # remaining budgets (LJF — co-resident slots drain together); the
        # oldest queued request is always included, so nothing starves.
        # "fifo" admits strictly in submit order.
        if admission not in ("budget", "fifo"):
            raise ValueError("admission must be 'budget' or 'fifo'")
        self.admission = admission
        # speculative serving: a draft (infer/speculative.py) proposes
        # spec_gamma tokens per slot per round; one [S, gamma+1] target
        # verify pass accepts the longest matching prefix + bonus.
        self._spec = spec_gamma > 0
        self._draft = draft_params
        self.spec_gamma = spec_gamma
        self.spec_rounds = spec_rounds
        if self._spec:
            if draft_params is None:
                raise ValueError("spec_gamma > 0 needs draft_params "
                                 "(infer.speculative.make_draft_params)")
            if adapter_bank is not None:
                raise ValueError(
                    "speculative serving does not compose with a LoRA "
                    "adapter bank (the self-draft merges ONE adapter)")
            if cfg.decode.kv_cache_dtype == "int8":
                raise ValueError(
                    "speculative serving needs a full-precision slot "
                    "cache (verify re-prefills into it); unset "
                    "decode.kv_cache_dtype")
            # the draft may be the full-depth self-draft OR a layer-skip
            # slice: a second slot-cache geometry [L_draft, S, ...]; only
            # heads/dims must match the target
            dcfg = draft_model_cfg or cfg.model
            if len(draft_params["llm"]["layers"]) != dcfg.llm.n_layers:
                raise ValueError(
                    f"draft depth {len(draft_params['llm']['layers'])} "
                    f"does not match draft_model_cfg.llm.n_layers="
                    f"{dcfg.llm.n_layers} — pass the ModelConfig that "
                    "make_layerskip_draft returned")
            tl, dl = cfg.model.llm, dcfg.llm
            if (dl.n_kv_heads, dl.d_model, dl.n_heads) != (
                    tl.n_kv_heads, tl.d_model, tl.n_heads):
                raise ValueError(
                    "speculative serving needs a draft sharing the "
                    "target's head geometry (layer-skip/quantized "
                    "self-drafts do); an alien draft architecture is "
                    "speculative_generate territory")
            self._draft_cfg = dcfg
        else:
            self._draft_cfg = cfg.model
        # multi-tenant LoRA serving: [K, ...] bank; every request picks a
        # row via submit(adapter=...). Needs the raw (unfused,
        # lora-bearing) base tree.
        self._bank = adapter_bank
        self._n_adapters = 0
        if adapter_bank is not None:
            self._validate_adapter_base()
            self._check_adapter_structure(ad.select_lora(adapter_bank, 0))
            self._n_adapters = ad.bank_size(adapter_bank)
        self.max_new = max_new_tokens or cfg.decode.max_new_tokens
        self._prompt_ids = tok.encode(cfg.model.prompt, add_bos=True)
        self.k_steps = k_steps
        self.k_max = k_steps       # adaptive chunk-length cap
        llm = cfg.model.llm
        if cache_len is None:
            # worst prefix: prompt + the largest feature bucket (features
            # never exceed mel frames; the slack absorbs connector choices)
            cache_len = len(self._prompt_ids) + cfg.data.audio_buckets[-1] + self.max_new
        self.M = -(-cache_len // 128) * 128
        self._kv_int8 = cfg.decode.kv_cache_dtype == "int8"
        if self._kv_int8:
            # int8 slot cache: staged rows quantize with per-slot scales
            # (decode writes reuse them), the static int8 path's math
            self.cache = L.init_cache(llm, self.S, self.M, torch.int8, self.device)
            sshape = (llm.n_layers, self.S, llm.n_kv_heads, 1, 1)
            self.cache = L.KVCache(
                self.cache.k, self.cache.v,
                torch.ones(sshape, dtype=torch.bfloat16, device=self.device),
                torch.ones(sshape, dtype=torch.bfloat16, device=self.device))
        else:
            self.cache = L.init_cache(llm, self.S, self.M, self.dt, self.device)
        if self._spec:
            # the draft's own slot-cache geometry: its OWN depth
            self.d_cache = L.init_cache(self._draft_cfg.llm, self.S, self.M, self.dt,
                                        self.device)
        # Slot STATE lives on the device and is updated in place by
        # install/decode_chunk (never read on the scheduling path); the
        # spec schedule keeps numpy mirrors it syncs each chunk.
        self._reset_device_state()
        self._reset_spec_state()
        self.slots = [_Slot() for _ in range(self.S)]   # spec schedule
        # pipelined schedule: slot -> resident request id, plus the host's
        # PREDICTED remaining budget per slot (budget exhaustion is
        # deterministic, so "free after the in-flight chunk" is known at
        # dispatch time; EOS finishes are learned one fetch later)
        self.slot_rid: list[int | None] = [None] * self.S
        self._pred_rem = np.zeros((self.S,), np.int64)
        self._reqs: dict[int, _Req] = {}
        # dispatch-ahead window: chunks in flight before the scheduler
        # blocks on a fetch
        self.pipeline_depth = max(pipeline_depth, 1)
        self._fetcher: _Fetcher | None = None
        self._inflight_n = 0       # chunks dispatched, not yet absorbed
        self._prep: _PrepWorker | None = None
        self._prep_rows = 0        # rows handed to the prep worker
        # per-slot sampling knobs are host state: they ride into each
        # dispatch as fresh device copies
        self.slot_temps = np.zeros((self.S,), np.float32)
        self.slot_tops = np.ones((self.S,), np.float32)
        self.slot_adapter = np.zeros((self.S,), np.int64)
        self._sampling = False     # this workload samples
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._pending_admits: list = []    # (group, tok0 on the device)
        self._staged: deque[_Staged] = deque()    # prefilled, pre-install
        # online request queue: (req_id, sample, budget, temp, top_p,
        # adapter); req ids are monotonically increasing submit order
        self._queue: deque = deque()
        self._next_req = 0
        self._outstanding: set[int] = set()
        self._cancelled: set[int] = set()   # staged/admitted, swept in step
        self._finished: dict[int, list[int]] = {}   # awaiting collection
        self.reset_stats()

    def _reset_device_state(self) -> None:
        dev = self.device
        self.d_cur = torch.zeros((self.S,), dtype=torch.int64, device=dev)
        self.d_last = torch.full((self.S,), self.tok.eos_id, dtype=torch.int64, device=dev)
        self.d_done = torch.ones((self.S,), dtype=torch.bool, device=dev)  # all idle
        self.d_rem = torch.zeros((self.S,), dtype=torch.int64, device=dev)

    def _reset_spec_state(self) -> None:
        # numpy mirrors of the speculative schedule's slot state, synced
        # each chunk; prev_tok/spec_gap are the e_{n-2} tail and the
        # draft-pending gap, reset via the `fresh` mask on admission
        self.cur_lens = np.zeros((self.S,), np.int64)
        self.last_tok = np.full((self.S,), self.tok.eos_id, np.int64)
        self.done = np.ones((self.S,), bool)
        self.prev_tok = np.full((self.S,), self.tok.eos_id, np.int64)
        self.spec_gap = np.ones((self.S,), np.int64)
        self._fresh = np.zeros((self.S,), bool)

    def _dev(self, x) -> torch.Tensor:
        """A device copy of a host array (a tensor passes through)."""
        if isinstance(x, torch.Tensor):
            return x
        return torch.tensor(np.asarray(x), device=self.device)

    # -- host-side scheduling --------------------------------------------

    def _collate(self, samples: list[Sample]) -> HostBatch:
        """Pad a group into a host batch (no device work)."""
        return collate_group(samples, self.cfg.data, self._prompt_ids, self.tok.pad_id)

    def _stage_group(self, group: list, hb: HostBatch | None = None) -> None:
        """Prefill (req, sample, budget, temperature, top_p, adapter) tuples
        in ONE :func:`stage` call, independent of slot availability
        (power-of-2 group sizes, as the JAX engine keeps them). ``hb`` is
        the group's host batch from the prep worker; without it the group
        is collated here."""
        if hb is None:
            hb = self._collate([s for _, s, *_ in group])
        batch = featurize(hb, self.device, self.dt, self.cfg.model)
        kw = dict(cache_len=self.M, compute_dtype=self.dt, use_kernel=self.use_kernel)
        rows, tok0, plens = stage(
            self.params, self.cfg.model, batch,
            self._dev(np.asarray([g[3] for g in group], np.float32)),
            self._dev(np.asarray([g[4] for g in group], np.float32)),
            self._gen, self._bank,
            (self._dev(np.asarray([g[5] for g in group], np.int64))
             if self._bank is not None else None),
            quantize=self._kv_int8, sampling=self._sampling, **kw)
        meta = [(req, budget, t, p, aid) for req, _, budget, t, p, aid in group]
        d_rows = None
        if self._spec:
            # draft prefill of the same prefixes: the self-draft tree
            # carries the target's encoders/connectors/embeddings, so
            # stage() with draft params reproduces the prefix and prefills
            # the draft cache rows (its first tokens are discarded)
            n = len(group)
            d_rows, _, _ = stage(
                self._draft, self._draft_cfg, batch,
                torch.zeros((n,), device=self.device), torch.ones((n,), device=self.device),
                **kw)
        self._staged.append(_Staged(meta, rows, tok0, plens, d_rows=d_rows))
        self.stages_run += 1

    def _install_group(self, staged: _Staged, slots: list[int]) -> None:
        """Copy the next ``len(slots)`` staged rows into free pool slots
        (one :func:`install`, no model compute). The spec schedule updates
        its slot state from the synced mirrors; the pipelined schedule the
        live device tensors."""
        g = len(slots)
        idxs = self._dev(np.arange(staged.next, staged.next + g, dtype=np.int64))
        meta = staged.meta[staged.next:staged.next + g]
        staged.next += g
        for slot, (_, _, t, p, aid) in zip(slots, meta):
            self.slot_temps[slot] = t
            self.slot_tops[slot] = p
            self.slot_adapter[slot] = aid
        budgets = self._dev(np.asarray([m[1] for m in meta], np.int64))
        slots_d = self._dev(np.asarray(slots, np.int64))
        if self._spec:
            self.cur_lens, self.last_tok, self.done = (
                self._dev(self.cur_lens), self._dev(self.last_tok), self._dev(self.done))
            t0_dev = install(self.cache, staged.rows, idxs, slots_d, self.cur_lens,
                             self.last_tok, self.done, self.d_rem, budgets, staged.tok0,
                             staged.plens, eos_id=self.tok.eos_id)
            install_rows(self.d_cache, staged.d_rows, idxs, slots_d)
            self._fresh[slots] = True
        else:
            t0_dev = install(self.cache, staged.rows, idxs, slots_d, self.d_cur,
                             self.d_last, self.d_done, self.d_rem, budgets, staged.tok0,
                             staged.plens, eos_id=self.tok.eos_id)
            for slot, (rid, budget, *_) in zip(slots, meta):
                self.slot_rid[slot] = rid
                self._pred_rem[slot] = max(budget - 1, 0)
        group = [(slot, req, None, budget) for slot, (req, budget, *_) in zip(slots, meta)]
        self._pending_admits.append((group, t0_dev))
        self.installs_run += 1

    # -- pipelined schedule (greedy/sampled) -------------------------------

    def _admission_group(self) -> list:
        """Pop the next power-of-2-width admission group. Budget-aware
        packing (admission="budget"): keep the oldest request (nothing
        starves), fill the rest with the LONGEST remaining budgets so
        co-resident slots drain together (LJF)."""
        q = self._queue
        w = 1 << (min(self.S, len(q)).bit_length() - 1)
        if self.admission == "budget" and len(q) > w:
            head = q.popleft()
            rest = sorted(q, key=lambda r: -r[2])
            take = rest[:w - 1]
            taken = {r[0] for r in take}
            kept = [r for r in q if r[0] not in taken]
            q.clear()
            q.extend(kept)
            return [head] + take
        return [q.popleft() for _ in range(w)]

    def _pump_staging(self) -> None:
        """Queue -> prep worker (host collate, off this thread) ->
        :func:`stage`, keeping up to ~2 pools' worth of prefilled rows
        ahead of the slots."""
        if self._queue and self._prep is None:
            # the worker holds no reference to the engine, so a dropped
            # engine is freed (close() also stops the thread)
            self._prep = _PrepWorker(functools.partial(
                collate_group, cfg=self.cfg.data, prompt_ids=self._prompt_ids,
                pad_id=self.tok.pad_id))
        ahead = self._prep_rows + sum(st.remaining for st in self._staged)
        while self._queue and ahead < 2 * self.S:
            group = self._admission_group()
            self._prep.submit(group)
            self._prep_rows += len(group)
            ahead += len(group)
        while self._prep is not None:
            item = self._prep.ready()
            if item is None:
                break
            group, hb = item
            self._prep_rows -= len(group)
            self._stage_group(group, hb)

    def _refill_pipelined(self) -> None:
        """Install staged rows into every free slot. A slot is free when
        its resident request was finalized (EOS learned at fetch) or its
        budget is provably spent by the already-dispatched chunks
        (pred_rem == 0) — the latter lets admission run a chunk ahead of
        the fetch."""
        self._pump_staging()
        while True:
            free = [s for s in range(self.S)
                    if self.slot_rid[s] is None or self._pred_rem[s] == 0]
            if not free or not self._staged:
                break
            st = self._staged[0]
            g = 1 << (min(len(free), st.remaining).bit_length() - 1)
            self._install_group(st, free[:g])
            if st.remaining == 0:
                self._staged.popleft()

    def _pick_k(self) -> int:
        """Chunk length for the next dispatch: run exactly to the next
        predicted slot completion when more work is waiting (freed slots
        refill promptly), or to the farthest one when draining. Floor 8:
        below that the per-dispatch overhead costs more than the idle
        slot-steps it saves."""
        occ = self._pred_rem[[s for s in range(self.S) if self.slot_rid[s] is not None]]
        occ = occ[occ > 0]
        if occ.size == 0:
            return 0
        waiting = bool(self._queue) or bool(self._staged) or self._prep_rows > 0
        k = int(occ.min()) if waiting else int(occ.max())
        return min(max(k, 8), self.k_max)

    def _dispatch_chunk(self, k: int) -> None:
        bank = self._bank
        out, steps = decode_chunk(
            self.params, self.cfg.model, self.cache, self.d_cur, self.d_last,
            self.d_done, self.d_rem, k, self._dev(self.slot_temps),
            self._dev(self.slot_tops), self._gen, bank,
            self._dev(self.slot_adapter) if bank is not None else None,
            k_max=self.k_max, eos_id=self.tok.eos_id, sampling=self._sampling,
            compute_dtype=self.dt, use_kernel=self.use_kernel)
        snap = [(s, rid) for s, rid in enumerate(self.slot_rid) if rid is not None]
        if self._fetcher is None:
            self._fetcher = _Fetcher()
        self._fetcher.submit(_Chunk(out, steps, k, snap, self._pending_admits))
        self._inflight_n += 1
        self._pending_admits = []
        self.chunks_run += 1
        self.steps_launched += k
        for s, _ in snap:
            self._pred_rem[s] = max(self._pred_rem[s] - k, 0)

    def _drain_fetches(self, finished: dict, block: bool = False) -> None:
        """Absorb fetched chunks (in dispatch order). Non-blocking: take
        whatever has arrived; blocking: wait for exactly one."""
        while self._inflight_n > 0:
            item = self._fetcher.done(block)
            if item is None:
                return
            self._inflight_n -= 1
            self._absorb(*item, finished)
            if block:
                return

    def _absorb_admits(self, admits: list, finished: dict, tok0s=None) -> None:
        if tok0s is None:
            tok0s = [t.cpu().numpy() for _, t in admits]
        for (group, _), t0 in zip(admits, tok0s):
            for j, (slot, rid, _, budget) in enumerate(group):
                req = self._reqs.get(rid)
                if req is None or req.finished:
                    continue
                if rid in self._cancelled:
                    self._cancel_resident(rid, slot)
                    continue
                req.tokens.append(int(t0[j]))
                if t0[j] == self.tok.eos_id or budget <= 1:
                    self._finalize(rid, slot, finished)

    def _absorb(self, chunk: _Chunk, fetched, finished: dict) -> None:
        """Route one fetched chunk's tokens to its requests (host
        bookkeeping only)."""
        out, steps, tok0s = fetched
        self._absorb_admits(chunk.admits, finished, tok0s)
        self.decode_steps_total += steps
        self.slot_capacity += steps * self.S
        eos = self.tok.eos_id
        for slot, rid in chunk.snap:
            req = self._reqs.get(rid)
            if req is None or req.finished:
                continue
            if rid in self._cancelled:
                self._cancel_resident(rid, slot)
                continue
            for t in out[slot, :steps]:
                if len(req.tokens) >= req.budget or (req.tokens and req.tokens[-1] == eos):
                    break
                req.tokens.append(int(t))
            if len(req.tokens) >= req.budget or (req.tokens and req.tokens[-1] == eos):
                self._finalize(rid, slot, finished)

    def _finalize(self, rid: int, slot: int, finished: dict) -> None:
        req = self._reqs.pop(rid)
        req.finished = True
        ids = req.tokens[: req.budget]
        finished[rid] = ids
        self._finished[rid] = ids
        self._outstanding.discard(rid)
        self.requests_done += 1
        self.tokens_emitted += len(ids)
        if self.slot_rid[slot] == rid:     # not already readmitted
            self.slot_rid[slot] = None
            self._pred_rem[slot] = 0

    def _cancel_resident(self, rid: int, slot: int) -> None:
        """Free a resident slot whose request was cancelled: one tiny
        :func:`mask_done` freezes the row at once (stream order keeps it
        ahead of any later install into the same slot)."""
        self._cancelled.discard(rid)
        self._reqs.pop(rid, None)
        if self.slot_rid[slot] == rid:
            mask = np.zeros((self.S,), bool)
            mask[slot] = True
            mask_done(self.d_done, self.d_rem, self._dev(mask))
            self.slot_rid[slot] = None
            self._pred_rem[slot] = 0
        self.requests_cancelled += 1

    def _step_pipelined(self) -> dict[int, list[int]]:
        finished: dict[int, list[int]] = {}
        # absorb whatever has already arrived, so EOS-freed slots refill
        # this very step
        self._drain_fetches(finished)
        self._refill_pipelined()
        # pool idle but prep still collating: wait for it rather than
        # spinning through empty steps
        if (self._inflight_n == 0 and not self._staged and self._prep_rows > 0
                and all(r is None for r in self.slot_rid)):
            group, hb = self._prep.ready(block=True)
            self._prep_rows -= len(group)
            self._stage_group(group, hb)
            self._refill_pipelined()
        k = self._pick_k()
        if k > 0:
            self._dispatch_chunk(k)
        # bound the dispatch-ahead window; on drain (nothing dispatched)
        # absorb everything outstanding
        depth = self.pipeline_depth if k > 0 else 0
        while self._inflight_n > depth:
            self._drain_fetches(finished, block=True)
        if self._inflight_n == 0 and self._pending_admits:
            # installs with no chunk behind them (e.g. budget-1 requests)
            self._absorb_admits(self._pending_admits, finished)
            self._pending_admits = []
        return finished

    # -- spec schedule (synchronous loop) ----------------------------------

    def _refill(self) -> None:
        """Fill every free slot from staged rows, staging new batches from
        the request queue as needed, then stage ONE batch ahead."""
        free = [s for s in range(self.S) if self.slots[s].req is None]
        q = self._queue

        def stage_next() -> None:
            w = 1 << (min(self.S, len(q)).bit_length() - 1)
            self._stage_group([q.popleft() for _ in range(w)])

        while free:
            if not self._staged:
                if not q:
                    break
                stage_next()
            st = self._staged[0]
            g = 1 << (min(len(free), st.remaining).bit_length() - 1)
            self._install_group(st, free[:g])
            free = free[g:]
            if st.remaining == 0:
                self._staged.popleft()    # staging buffer freed
        if not self._staged and q:
            stage_next()                   # prefill-ahead behind the chunk

    def _sync(self, extra: tuple = ()) -> list:
        """One blocking fetch: pending admissions' first tokens + the slot
        state (+ ``extra``, returned as numpy), into host bookkeeping."""
        pend = self._pending_admits
        self._pending_admits = []
        self.cur_lens = self._dev(self.cur_lens).cpu().numpy().copy()
        self.last_tok = self._dev(self.last_tok).cpu().numpy().copy()
        self.done = self._dev(self.done).cpu().numpy().copy()
        for group, t0 in pend:
            t0 = t0.cpu().numpy()
            for j, (slot, req, _, budget) in enumerate(group):
                self.slots[slot] = _Slot(req, [int(t0[j])], budget)
        return [self._dev(e).cpu().numpy().copy() for e in extra]

    def warmup(self, sample: Sample, *, sampling: bool = False) -> None:
        """Run every stage width and install group size (1, 2, 4, ..., S)
        and one decode chunk for one media shape, then reset the pool — so
        the first launches of every kernel on this thread's stream (the
        qmatmul split workspaces, the library handles) happen here, not
        mid-flight. ``sampling=True`` warms the per-slot sampling path."""
        self._sampling = sampling
        spec = self._spec
        w = 1
        while w <= self.S:
            self._stage_group([(-1, sample, 1, 0.0, 1.0, 0)] * w)
            st = self._staged.pop()
            g = 1
            while g <= w:
                install(self.cache, st.rows, self._dev(np.zeros((g,), np.int64)),
                        self._dev(np.arange(g, dtype=np.int64)), self.d_cur, self.d_last,
                        self.d_done, self.d_rem, self._dev(np.full((g,), 4, np.int64)),
                        st.tok0, st.plens, eos_id=self.tok.eos_id)
                g *= 2
            if spec:
                install_rows(self.d_cache, st.d_rows, self._dev(np.zeros((w,), np.int64)),
                             self._dev(np.arange(w, dtype=np.int64)))
            w *= 2
        if spec:
            decode_chunk_spec(
                self.params, self._draft, self.cfg.model, self.cache, self.d_cache,
                self.d_cur, self.d_last, self._dev(self.prev_tok),
                self._dev(self.spec_gap), self._dev(self._fresh), self.d_done,
                k_rounds=self.spec_rounds, gamma=self.spec_gamma, eos_id=self.tok.eos_id,
                compute_dtype=self.dt, use_kernel=self.use_kernel,
                draft_model_cfg=self._draft_cfg)
        else:
            decode_chunk(self.params, self.cfg.model, self.cache, self.d_cur, self.d_last,
                         self.d_done, self.d_rem, 2, self._dev(self.slot_temps),
                         self._dev(self.slot_tops), self._gen, self._bank,
                         (self._dev(self.slot_adapter) if self._bank is not None
                          else None),
                         k_max=self.k_max, eos_id=self.tok.eos_id, sampling=self._sampling,
                         compute_dtype=self.dt, use_kernel=self.use_kernel)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        # reset the pool: warmup rows are garbage by design
        self.slots = [_Slot() for _ in range(self.S)]
        self.slot_rid = [None] * self.S
        self._pred_rem[:] = 0
        self._reset_device_state()
        self._reset_spec_state()
        self._pending_admits = []
        self.reset_stats()         # warmup work is not serving work

    def reset(self) -> None:
        """Hard-reset the pool after a fault: drop every queued, staged,
        and resident request (their ids never finish — the caller fails
        them out, as infer/server.py does), and return every slot to idle
        so scheduling can resume. The cache is kept: stale columns are
        masked/overwritten by design."""
        self.slots = [_Slot() for _ in range(self.S)]
        self._reset_spec_state()
        self.slot_rid = [None] * self.S
        self._pred_rem[:] = 0
        self._reqs.clear()
        self._reset_device_state()
        if self._fetcher is not None:      # drop in-flight chunk fetches
            self._fetcher.close()
        self._inflight_n = 0
        while self._prep_rows > 0:         # drop in-flight prep results
            try:
                group, _ = self._prep.ready(block=True)
                self._prep_rows -= len(group)
            except Exception:              # noqa: BLE001 — resetting anyway
                self._prep_rows = 0
        self._pending_admits = []
        self._staged = deque()
        self._queue.clear()
        self._outstanding.clear()
        self._cancelled.clear()

    def close(self) -> None:
        """Stop the prep thread and drop in-flight fetches (the engine can
        be garbage-collected after this; ``step`` starts a new thread)."""
        if self._prep is not None:
            self._prep.close()
            self._prep = None
            self._prep_rows = 0
        if self._fetcher is not None:
            self._fetcher.close()
        self._inflight_n = 0

    def reset_stats(self) -> None:
        self.chunks_run = 0        # decode_chunk invocations
        self.stages_run = 0        # stage (batched prefill) invocations
        self.installs_run = 0      # install (row copy) invocations
        self.requests_done = 0     # requests completed across transcribes
        self.requests_cancelled = 0  # requests abandoned via cancel()
        self.tokens_emitted = 0    # tokens returned (incl. first + EOS)
        self.decode_steps_total = 0  # chunk steps taken while a slot was active
        self.slot_capacity = 0     # decode_steps_total * S (fetched)
        # chunk steps launched: the JAX loop would have stopped at the last
        # finish, so steps_launched - decode_steps_total were paid for
        # nothing (not in stats(), which keeps the JAX package's keys)
        self.steps_launched = 0
        # speculative schedule: draft steps launched, and slot-rounds
        # verified for a slot not yet done (kept tokens per such slot-round
        # is the tokens per verify pass)
        self.draft_steps = 0
        self.spec_slot_rounds = 0

    # -- online API ------------------------------------------------------

    def submit(self, sample: Sample, *, max_new: int | None = None,
               temperature: float = 0.0, top_p: float = 1.0, adapter: int = 0) -> int:
        """Enqueue one request — at any time, including mid-decode — and
        return its id. ``temperature <= 0`` decodes greedily; a sampled
        submission switches the pool to per-slot sampling (greedy rows
        within it still take exact argmax) until the pool drains and an
        all-greedy workload resets it. ``adapter`` picks the request's LoRA
        bank row (engines built with ``adapter_bank``)."""
        if not (0 <= adapter < max(1, self._n_adapters)):
            raise ValueError(
                f"adapter {adapter} out of range: this engine serves "
                f"{self._n_adapters or 'no'} adapter(s)")
        if temperature > 0.0 and self._spec:
            raise ValueError(
                "speculative serving is greedy-only: the rejection-"
                "sampling scheme needs per-slot draft distributions the "
                "slot chunk does not carry (use a non-spec engine for "
                "sampled workloads)")
        budget = max_new or self.max_new
        err = self.budget_error(sample, budget)
        if err:
            raise ValueError(err)
        rid = self._next_req
        self._next_req += 1
        if temperature > 0.0:
            self._sampling = True
        self._queue.append((rid, sample, budget, float(temperature), float(top_p),
                            int(adapter)))
        self._reqs[rid] = _Req([], budget)
        self._outstanding.add(rid)
        return rid

    def budget_error(self, sample: Sample, budget: int) -> str | None:
        """Why a request cannot fit its slot, or None: its prompt, its
        features (at most its audio bucket's mel frames, the bound the
        cache width is sized by) and ``budget`` tokens must fit the M
        columns of a slot. A write past them would be a device-side fault
        here (the JAX package drops such writes and decodes on silently).
        Host arithmetic only: callable from any thread."""
        buckets = self.cfg.data.audio_buckets
        feat = buckets[-1]
        if sample.audio is not None:
            mel = min(sample.audio.shape[0], self.cfg.data.max_audio_length) // HOP_LENGTH
            feat = pick_bucket(mel, buckets)
        if len(self._prompt_ids) + feat + budget > self.M:
            return (f"max_new {budget} does not fit a slot: prompt "
                    f"{len(self._prompt_ids)} + features <= {feat} + budget > the "
                    f"slot cache's {self.M} positions (max_new_tokens "
                    f"{self.max_new} sizes it)")
        return None

    def outstanding(self) -> int:
        """Requests submitted but not yet finished (queued + staged +
        resident)."""
        return len(self._outstanding)

    def _validate_adapter_base(self) -> None:
        """Bank/onboarding preconditions on the resident base tree."""
        if not self.cfg.model.lora.use_lora:
            raise ValueError(
                "adapter serving needs model.lora.use_lora=true (the "
                "bank rows ride the model's LoRA wiring)")
        if "qkv" in self.params["llm"]["layers"][0]:
            raise ValueError(
                "adapter serving needs the raw params layout, not the "
                "fused decode one (fuse_decode_layout concatenates "
                "projections the per-proj adapters must target)")

    def _check_adapter_structure(self, adapter: Params) -> None:
        """An adapter must mirror extract_lora(base) exactly — a silently
        mis-shaped tree (e.g. from a different-depth config) would
        truncate inject_lora's layer walk."""
        want = ad.structure(ad.extract_lora(self.params["llm"]))
        got = ad.structure(adapter)
        if got != want:
            raise ValueError(
                "adapter tree does not match this model's LoRA wiring "
                f"(got {got}, want {want})")

    def add_adapter(self, adapter: Params) -> int:
        """Onboard a LoRA tenant at runtime (no restart, no drain) and
        return its id. ``adapter`` is an ``extract_lora`` tree matching
        this model's LoRA wiring, on any device (it is copied to the
        bank's device and dtype).

        On a bank-less engine the first call CREATES the bank with row 0
        reserved for the base tree's OWN resident adapter (its lora
        leaves, which every request was already applying), so resident
        id-0 requests keep their numbers; the new tenant lands at id 1.
        Capacity grows by doubling with zero rows; between growths
        onboarding is a row copy."""
        if self._bank is None:
            self._validate_adapter_base()
            self._check_adapter_structure(adapter)
            base = ad.extract_lora(self.params["llm"])
            adapter = ad.tree_map(lambda a, b: a.to(b.device, b.dtype), adapter, base)
            self._bank = ad.stack_lora_bank([base, adapter])
            self._n_adapters = 2
            return 1
        self._check_adapter_structure(adapter)
        k, cap = self._n_adapters, ad.bank_size(self._bank)
        if k == cap:     # double capacity with zero rows
            self._bank = ad.tree_map(lambda b: torch.cat([b, torch.zeros_like(b)]), self._bank)
        ad.tree_map(lambda b, a: b[k].copy_(a), self._bank, adapter)
        self._n_adapters = k + 1
        return k

    def cancel(self, req_id: int) -> bool:
        """Abandon a live request and reclaim its slot capacity (timed-out
        or disconnected clients). Queued requests are reclaimed at once
        and resident ones at this call (their row is masked out of the
        next chunk); staged/mid-admission ones at the next step()
        boundary. Returns False if the id is unknown or already finished
        (collect its ids instead)."""
        if req_id not in self._outstanding:
            return False
        self._outstanding.discard(req_id)
        for i, item in enumerate(self._queue):
            if item[0] == req_id:          # never staged: free reclaim
                del self._queue[i]
                self._reqs.pop(req_id, None)
                self.requests_cancelled += 1
                return True
        if self._spec:
            for s, st in enumerate(self.slots):
                if st.req == req_id:
                    self.slots[s] = _Slot()
                    self.done[s] = True    # masked out of the next chunk
                    self.requests_cancelled += 1
                    return True
        else:
            for s, rid in enumerate(self.slot_rid):
                if rid == req_id:          # resident: freeze the row now
                    self._cancel_resident(req_id, s)
                    return True
        self._cancelled.add(req_id)        # staged / pending admission
        return True

    def _sweep_cancelled(self) -> None:
        """Free slots whose request was cancelled while staged or
        mid-admission (spec schedule)."""
        if not self._cancelled:
            return
        for s, st in enumerate(self.slots):
            if st.req is not None and st.req in self._cancelled:
                self._cancelled.discard(st.req)
                self.slots[s] = _Slot()
                self.done[s] = True
                self.requests_cancelled += 1

    def step(self) -> dict[int, list[int]]:
        """One schedule iteration; returns the requests that finished this
        step ({req_id: generated ids}).

        Greedy/sampled engines run the PIPELINED schedule: refill free
        slots, dispatch the next adaptive-length chunk, THEN absorb the
        oldest chunk once more than ``pipeline_depth`` are in flight, so
        the device has the successor queued when a chunk finishes.
        Results therefore surface a step or two after their chunk runs.
        Speculative engines keep the synchronous schedule."""
        if self._spec:
            return self._step_spec()
        return self._step_pipelined()

    def _step_spec(self) -> dict[int, list[int]]:
        finished: dict[int, list[int]] = {}

        def harvest(slot: int) -> None:
            st = self.slots[slot]
            ids = st.tokens[: st.budget]
            finished[st.req] = ids
            self._finished[st.req] = ids
            self._outstanding.discard(st.req)
            self._reqs.pop(st.req, None)   # spec tracks tokens in _Slot
            self.requests_done += 1
            self.tokens_emitted += len(ids)
            self.slots[slot] = _Slot()

        for s in range(self.S):
            st = self.slots[s]
            if self.done[s] and st.req is not None:
                if self.tok.eos_id in st.tokens or len(st.tokens) >= st.budget:
                    harvest(s)
        self._refill()
        if all(st.req is None for st in self.slots) and not self._pending_admits:
            return finished                          # pool is idle
        if self._sampling:
            raise ValueError("speculative serving is greedy-only "
                             "(submit with temperature=0)")
        fresh = self._dev(self._fresh)
        self._fresh[:] = False
        (self.cur_lens, self.last_tok, prev, gap, self.done, out, n_new, live,
         n_draft) = decode_chunk_spec(
            self.params, self._draft, self.cfg.model, self.cache, self.d_cache,
            self._dev(self.cur_lens), self._dev(self.last_tok), self._dev(self.prev_tok),
            self._dev(self.spec_gap), fresh, self._dev(self.done),
            k_rounds=self.spec_rounds, gamma=self.spec_gamma, eos_id=self.tok.eos_id,
            compute_dtype=self.dt, use_kernel=self.use_kernel,
            draft_model_cfg=self._draft_cfg)
        self.chunks_run += 1
        # the one blocking point per chunk: admissions' first tokens, slot
        # state and the chunk's tokens come back together
        toks, self.prev_tok, self.spec_gap, n_new, live = self._sync(
            (out, prev, gap, n_new, live))
        self.draft_steps += n_draft
        self.spec_slot_rounds += int(live)
        self._sweep_cancelled()        # admitted-then-cancelled rows
        for s, st in enumerate(self.slots):
            if st.req is None:
                continue
            for t in toks[s][: int(n_new[s])]:
                if len(st.tokens) >= st.budget:
                    break
                if st.tokens and st.tokens[-1] == self.tok.eos_id:
                    break
                st.tokens.append(int(t))
            # budget exhausted: free the slot even without EOS
            if len(st.tokens) >= st.budget or st.tokens[-1] == self.tok.eos_id:
                self.done[s] = True
        return finished

    def collect(self, req_id: int) -> list[int] | None:
        """Pop a finished request's ids (None if not finished yet).
        Finished results are kept until collected — callers that consume
        :meth:`step`'s return dict directly must still collect (as
        infer/server.py does per finish)."""
        return self._finished.pop(req_id, None)

    # -- offline convenience ---------------------------------------------

    def transcribe(self, samples, max_new_per_request: list[int] | None = None,
                   temperature_per_request: list[float] | None = None,
                   top_p_per_request: list[float] | None = None,
                   adapter_per_request: list[int] | None = None) -> list[list[int]]:
        """Run every request through the slot pool; returns generated ids
        per request, in input order. ``max_new_per_request`` caps each
        request (the host frees the slot the moment a budget is spent, as
        on EOS); ``temperature_per_request`` / ``top_p_per_request`` give
        each request its own sampling knobs (temperature <= 0 = greedy);
        ``adapter_per_request`` its bank row."""
        n_req = len(samples)
        budgets = max_new_per_request or [self.max_new] * n_req
        temps_l = temperature_per_request or [0.0] * n_req
        tops_l = top_p_per_request or [1.0] * n_req
        aids_l = adapter_per_request or [0] * n_req
        if not self._outstanding:        # idle pool: sampling resets to
            self._sampling = False       # what this workload needs
        ids = [self.submit(s, max_new=b, temperature=t, top_p=p, adapter=a)
               for s, b, t, p, a in zip(samples, budgets, temps_l, tops_l, aids_l)]
        want = set(ids)
        while want & self._outstanding:
            self.step()
        return [self._finished.pop(i) for i in ids]

    def stats(self) -> dict:
        """Serving telemetry across this engine's lifetime. Chunk
        utilization = useful tokens emitted by decode chunks / chunk-step
        slot capacity (the rest is idle/finished-slot padding)."""
        if self._spec:
            # spec mode: a chunk's capacity is its verify positions
            cap = self.chunks_run * self.spec_rounds * (self.spec_gamma + 1) * self.S
            steps = self.chunks_run * self.spec_rounds
        else:
            cap = self.slot_capacity
            steps = self.decode_steps_total
        chunk_tokens = self.tokens_emitted - self.requests_done  # tok0s are
        return {                                # prefill-stage outputs
            "requests_done": self.requests_done,
            "requests_cancelled": self.requests_cancelled,
            "tokens_emitted": self.tokens_emitted,
            "chunks_run": self.chunks_run,
            "decode_steps": steps,
            "stages_run": self.stages_run,
            "installs_run": self.installs_run,
            "chunk_utilization": round(chunk_tokens / cap, 4) if cap else 0.0,
        }
