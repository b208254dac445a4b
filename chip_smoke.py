"""Smoke run of the PyTorch/CUDA port (avsr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

1. Builds every CUDA kernel of the port from the sources in this checkout.
2. Kernel phase: calls each kernel's wrapper at the shapes the serving path
   gives it (bf16) and holds it against its plain PyTorch version, then
   times the kernel and one PyTorch library call that computes the same
   function (a yardstick only; the port never calls it) from replayed CUDA
   graphs, and the plain version eagerly.
3. Main-path phase: the flagship config (Whisper-medium + CLIP-B/32 +
   Llama-3.2-1B with LoRA r=16, modality both) at full width with random
   bf16 weights from --seed; 8 utterances of 10 s audio and 25 video
   frames go through collate -> featurize -> generate_tokens (100 greedy
   tokens). Every kernel launch count is reset just before that run and
   read just after it; the prefill logits are compared with the same call
   with the kernels off.
4. CLI phase: the decode CLI over 8 synthetic utterances writes its
   results and WER files.
5. Backward kernel phase: the dQ and dK/dV kernels at the train step's
   attention shape (bf16, causal GQA) against their plain version (dQ
   hands its delta = rowsum(dO * O) to dK/dV), f32 and edge cases, the
   autograd Function against autograd through the plain attention, and
   times of each kernel, its plain version, its bound and the SDPA
   backward; the flash kernels and SDPA are timed from replayed CUDA
   graphs.
6. Train phase: the flagship train step at full width (random weights from
   --seed, frozen leaves bf16, trainable f32) on 8 x 10 s utterances with
   48-token transcripts: f32 and bf16 gradient parity of the kernel path
   against the plain path, three optimizer steps at base.yaml settings
   (4 x 8 micro-batches, remat, dropout) with exact launch counts per
   step, and a short overfit run whose loss must fall.
7. Train CLI phase: two steps of the train CLI write loss_log.csv.
8. qmatmul kernel phase: the int8 and int4 weight-only matmul kernels at
   every decode shape of the flagship (M = 8: the int4 projections qkv, o,
   gateup, down, the int8 lm head, and the int8 projections of use_8bit)
   against their plain version, edge cases (M of 1, 5, 9, 17 and 64, f32
   x, N off the tile, K off either kernel's k step, a K that does not
   match), the same bits from two launches and from a replayed CUDA graph,
   and the device time of the kernel, its plain version, its bound, one
   bf16 matmul on the dequantized weight and the dequantize-then-matmul
   pair, each from a replayed CUDA graph; each shape's launch plan.
9. Serving-preset phase: the flagship with use_4bit, lm_head_bits=8 and
   an int8 KV cache, built as the decode CLI builds it, on the same 8
   utterances: exact launch counts of one generate_tokens call, decode-step
   logits of the kernel path against the dequantize path (f32 and bf16),
   the serving numbers next to phase 3's and to the same weights
   unquantized.
10. int8 serving phase: the same with use_8bit in place of use_4bit (int8
   projections and head, int8 KV cache): exact launch counts and the same
   decode-step logit gates. Then the decode CLI with the preset overrides.
11. Checkpoint phase, through the CLIs at full width (LoRA dropout off):
   run A trains 2 steps with a checkpoint each, validation and in-training
   WER; run B resumes it for a third step (no WER eval); run C takes 3 steps
   uninterrupted, and B's third step must equal C's (its batches, loss and
   trainable leaves). The decode CLI reads the checkpoint in bf16 (the
   connector and LoRA leaves it loaded equal B's) and with the serving
   preset (quantized after loading), each followed by one generate_tokens
   call with exact launch counts; the average CLI's export of the last two
   steps is their f32 mean and decodes; a run sent SIGTERM after step 1
   saves a preempt checkpoint at step 2 and the next run resumes from it
   (both at ``MESH_DEPTH``). A JAX run continued and served: run A's step
   2 in the numpy layout that ``tools/orbax_to_port.py`` hands over
   (``jax_numpy_state``; the card's host has no JAX to restore an Orbax
   step) is imported by ``train/import_state.py`` into a fresh directory
   with run A's JSON (bit-equal to the step), the train CLI resumes it for
   step 3 (its batches, loss and trainable leaves equal run C's, with
   exact launches) and the decode CLI's hypotheses from it equal those
   from run A's directory. Prints the checkpoint's size and its save,
   restore and WER-eval times, the import's seconds and GB, and removes
   every directory it wrote. Then ``preprocess_frames`` on the card
   against the CPU (25 frames of 160 x 120 to 224, f32 and bf16).
12. Train-knobs phase (``train_knobs_phase``), at full width: QLoRA with
   ``--mode 4bit`` (f32 gradient parity of the kernel path, three steps
   with their split, peak memory below phase 6's, the dequantize calls of
   a step and their device time; the train CLI's runs A, B (resumed) and
   C as in phase 11, B's third step equal to C's bit for bit; B and C
   leave out the in-training WER eval that A checks), the decode
   CLI from that checkpoint with the serving preset (loaded leaves equal
   the checkpoint's, exact launch counts), one step each of ``--mode
   8bit`` and ``--mode max``, ``model.unfreeze_layer_norms`` (f32 gradient
   parity of the encoder layer norms, the Whisper encoder's dQ and dK/dV
   launches, both kernels timed at the Whisper shape), the batch-size
   probe at the worst-case bucket in bf16 and 4bit, SpecAugment and video
   augmentation (padding bit-identical, the eval step unchanged), and two
   steps each of adafactor and lion with their state bytes.
13. Decode-variants phase (``decode_variants_phase``), at full width on the
   same 8 utterances as phase 3. In f32 (TF32 off): beam search (W = 5, 32
   tokens) equal to a flat-cache oracle token for token and score for
   score (relative 1e-4), W = 1 equal to greedy; speculative decoding
   (gamma 4, 32 tokens) with the int8 and int4 self-drafts and an 8-layer
   layer-skip draft equal to greedy, with exact launches per counted draft
   step; the streaming continuation (``prefill_extend`` of the first 7/16
   of the prefix, then ``generate_continue``) equal to greedy. In bf16 and
   the serving preset: beam search over 32 tokens with its numbers and
   exact launches, and one preset beam step's logits against the
   dequantize path with phase 9's gates; speculative decoding with each
   draft over 32 tokens beside greedy (verify passes, tokens per pass,
   ms per token), and sampling repeatable from one seed. Then the flagship's
   random init exported as a teacher, two steps of the distill CLI with a
   4-layer student (exact launches per step), and the decode CLI in f32
   greedy and speculative with the distilled draft: the same HYP lines.
   Last, the int4 and int8 kernels at M = 40 (the beam step's rows) and
   the int4 head at M = 8, timed as in phase 8.
14. Serving phase (``serving_phase``), at full width: 16 requests of 4-10 s
   synthetic audio and 25 frames from --seed with budgets of 10-100 new
   tokens, through the continuous-batching engine with 8 slots (a slot
   cache of M = 3200 columns). In f32: every request equal to
   ``generate_tokens`` for it; speculative slots (int8 self-draft, gamma 4)
   equal to the greedy engine, with tokens per verify pass; the multi-LoRA
   bank (the base and 3 random adapters, a fourth onboarded mid-flight)
   equal to ``generate_tokens`` with each request's adapter; exact
   streaming (10 s in 1 s chunks) whose finalize equals the offline
   decode. In bf16, the preset and use_8bit: utterances/s, new tokens/s,
   slot occupancy, p50/p95 latency and time to first token, peak memory,
   the steps run past the last finish, and the same 16 requests as static
   ``generate_tokens`` batches of 8 in the same run; the preset engine's
   decode step against the dequantize path with phase 9's gates; a decode
   step at M = 640 and M = 3200; streaming ms per chunk, exact and
   blockwise (2 s blocks). The HTTP server (audio-only flagship) on
   127.0.0.1 with 16 concurrent clients and one num_beams 5 client: in f32
   the responses equal ``generate_tokens`` and ``beam_search``; in bf16
   p50/p95 latency and requests/s; a timed-out request is cancelled in
   the engine. Exact launch counts on every path.
15. Corpus phase (``corpus_phase``), at full width: 48 utterances of 2-10 s
   written as real files from --seed by ``prepare_data.make_demo`` (PCM16 WAVs, a quarter at 48 kHz; 96 x
   96 frames at 25 per second as .npy, resized to 224 on the host; 2-7 word
   transcripts), manifests by the prepare_data CLI's scan mode (24 / 12 /
   12). The train CLI takes one epoch (3 steps of 8, the native batch WAV
   decode over 4 fetch threads) and validates; the decode CLI scores the
   test split from its checkpoint in bf16 and with the serving preset, each
   utterance once. The compact link (int16 PCM, planar YUV420): the first
   batch's featurize against the raw one at the JAX package's bounds, one
   train step and the bf16 decode. The f32 engine admits the test split
   straight from the manifest dataset (WAV decode deferred; compact link)
   and equals generate_tokens token for token. Prints the loader's pace:
   host prep per batch with 1 and 4 fetch threads, the consumer's wait per
   batch against the step, and the native batch decode against per-file
   Python. Removes what it wrote.
16. Convert phase (``convert_phase``), at full width and ``MESH_DEPTH``
   (6 Whisper, 3 CLIP and 4 LLM blocks; HuBERT's 12 whole): random weights
   from
   --seed written as HF directories without ``transformers`` (HuBERT-base
   as ``HubertModel`` keys in f32 with the legacy ``weight_g``/``weight_v``
   positional conv; Llama-3.2-1B as ``LlamaForCausalLM`` keys in bf16,
   tied, in two safetensors shards and an index; Whisper-medium's encoder
   as ``model.encoder.*`` keys in a ``pytorch_model.bin``; CLIP-B/32 as
   ``vision_model.*`` keys), converted by ``cli/convert_hf.py`` for both
   shipped configs (``flagship()`` and ``hubert_base()`` at that depth): every converted
   leaf equals the written one bit for bit, the positional conv within f32
   rounding (1e-5 of max|w|). ``hubert_base`` on phase 15's corpus from its
   export: 3 LoRA steps of the train CLI, 1 with ``unfreeze_layer_norms``,
   the decode CLI over the test split in bf16 and with the serving preset
   (each utterance scored once); in f32 ``generate_tokens`` from the export
   equals it from the in-memory conversion, the engine (deferred WAVs, the
   compact link) equals ``generate_tokens``, and exact streaming equals
   the offline decode. A reference-trainer ``.pt`` at the flagship's width
   and ``MESH_DEPTH`` (peft-wrapped bf16 LLM, r = 16 LoRA, simple
   connectors) through
   ``cli/convert_ref_ckpt.py``: the adapters are Aᵀ, Bᵀ and the connectors
   Wᵀ exactly, and one batch decodes. Exact launch counts on every path;
   the flash forward at HuBERT's shape ([8, 12, 512, 64], 499 valid rows)
   against its plain version, with its time, bound and SDPA's time. Prints
   the GB written and read and the seconds. Removes what it wrote.
17. Connector phase (``connector_phase``), at full width: the flagship's
   encoders and LLM built once (bf16, --seed) and each of the eight other
   connectors (deep, conv, attention, adaptive, cross_modal, qformer,
   perceiver, adapter) swapped in from seed + 1700: one ``generate_tokens``
   call (B = 8, 10 s audio, 25 frames, 32 tokens: encode, prefill, ms per
   token, peak memory) and one LoRA train step of 8 after a warm-up step,
   with launches exact by the derivation (``connector_launches``:
   ``attention`` and ``adaptive`` add one flash forward at head width 256
   per encode and one dQ and dK/dV per step, the others none; ``qformer``'s
   and ``perceiver``'s short prefixes keep the LLM under the dispatch
   threshold); the audio connector's own launches are also counted alone
   (one call, and one forward and backward). The forward, dQ and dK/dV at
   the connectors' [8, 8, 500, 256] (Whisper's trimmed output), a ragged
   set at 512 rows and the 30 s
   ``adaptive`` shape (375 rows), bf16 and f32, held to their plain
   versions and timed (``connector_kernel_rows``). In f32 the engine (4
   slots, 8 ragged requests) equals ``generate_tokens`` token for token
   with ``attention`` and ``qformer``. The train CLI (2 steps) and the
   decode CLI (the test split) with ``cross_modal`` on phase 15's corpus.
   Removes what it wrote.
18. MoE phase (``moe_phase``), at full width: ``flagship_moe()``, the
   flagship with the ``moe`` connector (8 experts, top-2, capacity factor
   1.25, hidden 2 x 2048) and every second Llama block sparse (8 SwiGLU
   experts of 8192, top-2), random weights from --seed. A static bf16 call
   (B = 8, 10 s audio, 25 frames, 32 tokens: encode, prefill, ms per token,
   peak memory); a bf16 train step of 8 (accum 1, 48-token transcripts)
   after a warm-up step, with finite router losses, run again from an
   identical state with bit-equal results (no float atomics on the gradient
   path); the serving preset's call (its routers and experts stay float:
   2 int4 products per MoE block and step) with phase 9's decode-step logit
   gates. In f32 with both capacity factors at 0.25 (tokens drop): the
   kernel path's prefill logits against the plain path's; the engine (4
   slots, 8 requests of 4-14 s in the 10 s and 20 s buckets, budgets <= 16)
   equal to ``generate_tokens``; speculative decoding (int8 self-draft,
   gamma 4) equal to greedy; beam search (W = 5) to its end; the decode CLI
   on phase 15's corpus, static and ``decode.engine_slots=4``, with equal
   HYP lines. Launches exact on every path, derived from the tree and the
   widths. Removes what it wrote.
19. Video-encoder phase (``video_encoder_phase``), at full width:
   ``flagship(video_encoder=...)`` with ResNet-50, EfficientNet-b0 and
   AV-HuBERT-base (88 px gray crops), random weights from --seed. For each:
   a static bf16 call (B = 8, 10 s audio, 25 frames, 32 tokens: encode,
   prefill, ms per token, peak) and the encoder's own forward at 25 and 100
   frames; a train step of 8 (accum 1) after a warm-up step, repeated bit
   for bit from an identical state; the encoder in f32 on the card (TF32
   off) against the same function on the CPU (max|d| <= 1e-4 max|ref|) and
   bf16 against f32 (mean|d| <= 0.1 std); the f32 engine (4 slots, 8
   requests of 4-10 s, budgets <= 16) equal to ``generate_tokens``; the
   published layout written from the seed (a ``ResNetForImageClassification``
   safetensors directory, an ``EfficientNetForImageClassification`` ``.bin``
   directory, a fairseq ``.pt`` whose config class does not import) and
   converted by ``cli/convert_hf.py``, every leaf bit-equal (the positional
   conv within 1e-5 of max|w|). Then AV-HuBERT at 300 frames (304 rows,
   ragged lengths): the attention kernels held to their plain versions
   and timed there, 12 flash launches per encode, the f32 kernel path
   against ``mha_reference``; a step with ``finetune_avhubert_layers=[10,
   11]`` that moves blocks 10-11 only and repeats bit for bit; the train (2
   steps) and decode CLIs with AV-HuBERT on phase 15's corpus over the
   compact link; one serving-preset call with ResNet. Launches exact on
   every path. Removes what it wrote.
20. Tooling phase (``tooling_phase``), at full width on the flagship,
   random weights from --seed: the validate CLI over 2 synthetic batches
   (rc 0, 40 flash launches a batch), then from an export whose first LoRA
   leaf is NaN (rc 1, and ``FloatingPointError`` under ``--checkify``); the
   analyze_memory CLI (every component's bytes on the card at least its
   logical bytes, the allocator's delta beside them, the four modes'
   totals); the profile CLI over 2 train steps at the largest buckets (B =
   8) and over one decode call of 32 tokens in bf16: each trace's kernels
   by name (the CLI's ``kernels_in_trace``, from its one read of the
   trace) equal the wrappers' counters over the traced steps, its device
   time, duty cycle and top categories, scopes and kernels printed. The
   serving preset's decode is not profiled here: the preset CLI phase and
   phases 22-25 check its int4 and int8 launches exactly. Removes what it
   wrote.
21. Mesh phase (``mesh_phase``), at the flagship's widths and a quarter
   of its depth (6 Whisper, 3 CLIP and 4 LLM blocks), random weights from
   --seed: ranks started as ``python3 chip_smoke.py
   --mesh-worker DIR`` with torchrun's environment, 2 sharing card 0 over
   gloo (and, where there are two cards, 2 on two cards over NCCL, which
   run the same steps and CLIs); the ranks of a layout stay up for the
   jobs of phases 21-24 (a pool, which saves each later phase the start
   of its processes), each job waited for with a timeout; a failing rank
   fails the phase. Each rank first asks the
   backend for every collective the port makes on CUDA tensors. Train steps at the largest buckets (3000 mel frames, 100 video
   frames, 10-48 label tokens, LoRA dropout on, accum 1) under ``dp=2``
   and ``fsdp=2``: in f32 (TF32 off, global B = 4) one step whose loss,
   grad norm and two LoRA ``b`` leaves equal the one-process run's (the
   CPU tests' gates), then in bf16 (global B = 8) two steps, each step's ms
   and the peak memory per rank beside one process's. The train CLI (f32,
   global batch 2, 1 step under ``fsdp=2``: rank 0 writes the gathered
   tree) and a resume at world 1 from its checkpoint to a second give one
   card's two losses, and rank 0 alone wrote the log. The decode CLI over
   8 synthetic utterances (16 tokens) on 2 ranks: f32 hypotheses equal
   one card's batch of 8, bf16's and the preset's one card's at the
   per-rank batch of 4; ms per token step beside one card's. Every rank's
   launches are counted (the flash kernels on every train path, the
   qmatmul kernels under the preset) and go into the ``kernels`` line.
   Removes what it wrote.
22. Tensor-parallel phase (``tp_phase``), at full width and phase 21's
   quarter of the depth on the flagship (its one-process references too,
   which phases 23 and 24 reuse), random weights from --seed:
   ``mesh.tp=2`` over 2 ranks
   sharing card 0 (gloo), and where there are 2 cards over NCCL, and where
   there are 4 ``mesh.dp=2 mesh.tp=2`` over NCCL (the first line says which
   ran), each rank started as phase 21's are and asked for every collective
   of the backend table, the tp operators included. Train steps at the
   largest buckets with phase 21's seeds at a global batch of 1 (every tp
   rank holds all rows, and over gloo a step's time is its all-reduces'
   bytes): f32 (TF32 off) one step whose loss, grad norm and two LoRA
   ``b`` leaves equal a one-process run's (phase 21's gates), then bf16 two
   steps, ms and peak per rank. The train CLI (f32, global batch 1, 1 step
   on the ranks) and a resume at world 1 to a second give one card's two
   losses. The decode CLI in f32 (8 utterances, 16 tokens) writes one
   card's HYP lines; direct ``generate_tokens`` calls (B = 8, 8 tokens) in
   bf16 and with the serving preset give prefill logits no further from
   the mode's f32 logits than 2x one card's (mean and max; phase 13's bf16
   gate), the share of tokens equal to one card's and ms per token step
   beside one card's. Every rank launches the flash forward, the backward
   pair in training, and under the preset the int4 kernel on column and
   repacked row slices (their K printed) and the int8 head on its vocab
   slice; the launches go into the ``kernels`` line.
   Removes what it wrote.
23. Sequence-parallel phase (``sp_phase``), at full width and depth on the
   flagship, random weights from --seed: ``mesh.sp=2`` over 2 ranks
   sharing card 0 (gloo), and where there are 2 cards over NCCL, and where
   there are 4 ``mesh.dp=2 mesh.sp=2`` over NCCL, started as phase 21's
   ranks are and asked for every collective of the backend table, the
   ring's shift and the sp operators included. On each rank, the ring
   attention (bf16, the flash kernels) at the 30 s bucket's Whisper shape
   (1504 rows, 1500 valid: 752 a rank, 748 valid keys on rank 1) and LLM
   shape (33 prompt + 1500 features + 48 labels packed to 1584, causal GQA)
   against ``mha_reference`` of the whole sequence, forward and q/k/v
   gradients (the flash gates), the blocks' launches exact, and the ring
   forward's ms with the kernels and with the plain blocks. Then phase
   22's train steps, direct decodes and train and decode CLIs with
   ``sp=2`` in place of ``tp=2``, at its quarter depth, against its
   one-process runs of them (``--sp-only`` makes those itself); each
   rank's train-step launches are exact (the frozen Whisper's 6 blocks
   twice a rank, the LLM's 4 causal blocks i + 1 times on rank i, twice
   under remat, with a backward pair each), and the decodes report their
   ring dispatches and the prefill's fallback (10 s gives a 533-row
   prefix, which does not divide over 2: JAX's warning). The ring's
   launches per rank go into the ``kernels`` line as ``sp_ring``. Removes
   what it wrote.
24. Pipeline-parallel phase (``pp_phase``), at full width on the
   flagship, LoRA dropout off (JAX refuses it under pp): ``mesh.pp=2``
   over 2 ranks sharing card 0 (gloo), and where there are 2 cards over
   NCCL, and where there are 4 ``mesh.dp=2 mesh.pp=2`` over NCCL, started
   as phase 21's ranks are and asked for every collective of the backend
   table, the pipeline's included. Train steps at full depth (8 LLM blocks
   a stage) and the largest buckets, global batch 2 (2 microbatches of a
   row): f32 (TF32 off) one step whose loss, grad norm and two LoRA ``b``
   leaves (layer 0's and the last layer's: one a stage) equal a
   one-process run's (phase 21's gates), then bf16 two steps, ms and peak
   per rank beside one process's; each rank's launches exact (the frozen
   Whisper's 24 blocks, the stage's 8 causal blocks once per microbatch,
   twice under remat, with a backward pair each: ``pp_stage`` in the
   ``kernels`` line). At phase 22's quarter depth, the train CLI (f32,
   global batch 2, 1 step on the ranks, rank 0 writes) and a resume at
   world 1 to a second step give one card's two losses; the decode CLI in
   f32 writes phase 22's one-card HYP lines (``--pp-only`` makes them),
   and under the serving preset every rank launches the qmatmul kernels
   (decoding runs the whole stack on every rank, as JAX's does). Removes
   what it wrote.
25. Expert-parallel phase (``ep_phase``), at full width on
   ``flagship_moe()`` with both capacity factors at 0.25 (the bounded
   training routing drops assignments), phase 18's bucket (10 s audio, 25
   frames), random weights from --seed: ``mesh.ep=2`` over 2 ranks sharing
   card 0 (gloo, phase 24's rank pool), and where there are 2 cards over
   NCCL, and where there are 4 ``mesh.dp=2 mesh.ep=2`` over NCCL. Each rank
   holds E / 2 of every expert leaf. Train steps at full depth: f32 (TF32
   off) one step at a global batch of one row per data rank whose loss,
   grad norm, ``moe_lb``, ``moe_z``, an expert leaf of the connector and
   two LoRA ``b`` leaves equal a one-process run's, with assignments
   dropped on every rank, then bf16 two steps at 4 rows per data rank, ms
   and peak per rank beside one process's; under ``mesh.sp=2`` one f32
   step at phase 21's quarter depth and the largest buckets (the LLM's
   tokens routed over the ring's chunks) with the same gates. Each rank's
   launches exact (``ep_ranks`` in the ``kernels`` line). At the quarter
   depth and audio-only (one moe connector: the train CLI's checkpoints
   hold its experts' Adam moments), the train CLI (f32, 1 step on the
   ranks, a resume at world 1) gives one card's two losses, the f32
   decode CLI one card's HYP lines, and under the serving preset every
   rank launches the qmatmul kernels. Removes what it wrote.
26. Llama-2 phase (``llama2_phase``): first the flash forward, dQ and
   dK/dV at the head widths of ``WIDTHS_CHECKED`` (64-512 by 64, 192-448 on
   the next wider kernel: the bf16 forward at the operands' own width, the
   rest over zero-padded operands; 576, 640, 768, 896, 1024 and 2048 on
   the panel kernels, the bf16 forward on a cluster of ceil(D / 256) CTAs;
   2112 past the largest cluster) against their plain versions in bf16
   (2e-2 x max|ref|) and f32 (1e-4): causal GQA over ragged rows and
   non-causal MHA with Tq != Tk and a row without keys; then at the shapes
   of phases 26 and 27 (``WIDTH_SHAPES``: the 7B's and the 13B's prefill
   and train step, the connectors' heads of 512, 640 and 1024, 896, 384 by
   the pad route, and 2048 at B = 2; above 512 in f32 too) the same checks
   and their times beside bound, plain version and SDPA (with the backend
   SDPA took), the cluster size, and at 384 the pad copies the forward no
   longer makes apart from the backward's; then the bf16 forward at each
   of ``PAD_ROUTE_WIDTHS`` on [8, 8, 500, D]: no copy, O and lse bit for
   bit the padded kernel's, timed. A refused cluster launch raises, and
   fails the phase. Then ``flagship_llama2()``, the flagship with the
   reference's other LLM, Llama-2-7B (MHA, heads of 128, untied head, vocab
   32000, theta 1e4), and the ``attention`` connector (8 heads of 512), at
   full width and ``LLAMA2_QUARTER``'s depth (6 Whisper, 3 CLIP and 8 LLM
   blocks: phase 27 runs the same kernels at full depth), random bf16
   weights from --seed made on the card: a static call (B = 8, 10 s audio,
   25 frames, 32 tokens: encode, prefill, ms per token, peak; 6 + 1 + 8
   flash launches); a train step of 8 (accum 1) after a warm-up step,
   repeated bit for bit from an identical state (23 forward, 9 dQ and 9
   dK/dV launches); the serving preset's call (int4 projections, the int8
   head over the vocab padded to 32768, exact launches). In f32 at the same
   depth: prefill logits with the kernels within 2e-2 of their std of the
   plain path's, and 16 greedy tokens equal. The 7B's decode products at
   M = 8 against their plain versions, timed beside bound and cuBLAS.
27. Llama-2-13B phase (``llama2_13b_phase``): ``flagship_llama2_13b()``,
   the flagship with Llama-2-13B (``meta-llama/Llama-2-13b-hf``'s
   config: 5120 wide, 40 blocks of 40 MHA heads of 128, ffn 13824, vocab
   32000, untied head) and the ``attention`` connector (8 heads of 640: the
   panel kernels), at full width and depth, random bf16 weights from
   --seed made on the card, as phase 26's runs: a static call (24 + 1 + 40
   flash launches), a train step of 8 repeated bit for bit (105 forward,
   41 dQ and 41 dK/dV launches), the serving preset's call (its f32 init
   after the bf16 tree is freed; 4960 int4 and 32 int8 launches), and in
   f32 at ``LLAMA2_13B_REDUCED`` (6 Whisper, 3 CLIP and 10 LLM blocks) the
   kernel path against the plain path; the 13B's decode products at M =
   8. Then the ``attention`` connector at Llama-2-70B's width alone (1024
   to 8192: 8 heads of 1024) over 8 x 500 ragged rows, a forward and
   backward in bf16 and f32 through the kernels against the plain path.

The build's ptxas report is printed per kernel, and any kernel that spills
fails the run.

Prints the card's name and power limit, one JSON line with every kernel's
numbers, and as its last line {"ok": true, "device": {...}}. With
``--mesh-only`` it builds the kernels and runs phase 21 alone (on a host
with two cards or more, the NCCL ranks too) and prints its results as one
JSON line instead; ``--tp-only``, ``--sp-only``, ``--pp-only`` and
``--ep-only``, ``--llama2-only`` and ``--llama2-13b-only`` do the same for phases 22,
23, 24, 25, 26 and 27. Each
phase boundary prints the
seconds so far. Any failed
check raises, so the script exits non-zero and prints no result; so does a
host without a CUDA device or a directory without the package.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import gc
import itertools
import json
import logging
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12         # H100 SXM HBM3 bytes/s
# base.yaml's values where they differ from the config defaults: the
# flagship config through CLI overrides (the card's host has no PyYAML)
FLAGSHIP_OVERRIDES = ("data.audio_buckets=1000,2000,3000",
                      "model.max_seq_len=1536", "training.grad_accum_steps=4")
# the serving preset of docs/serving.md
PRESET_OVERRIDES = ("model.use_4bit=true", "decode.lm_head_bits=8",
                    "decode.kv_cache_dtype=int8")
# the preset with int8 projections (model.use_8bit)
INT8_OVERRIDES = ("model.use_8bit=true", "decode.lm_head_bits=8",
                  "decode.kv_cache_dtype=int8")


class CheckFailed(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA
    events around the whole run, after a warm-up)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@functools.lru_cache(maxsize=None)
def capture_stream():
    """The one side stream of every timed capture: cuBLAS keeps a workspace
    (32 MiB on Hopper) for each stream it has run on until the process
    ends, so a new stream per capture would hold memory that later phases'
    peak-memory readings count."""
    import torch

    return torch.cuda.Stream()


def graph_ms(fns, reps: int = 20) -> float:
    """Device time per call of ``fns`` (called in turn, max(reps,
    len(fns)) calls in all) captured in one CUDA graph and replayed three
    times: the host's launch pace is not in the time, which matters for
    kernels of a few microseconds."""
    import torch

    reps = max(reps, len(fns))
    side = capture_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for f in fns:                     # warm-up outside the capture
            f()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for i in range(reps):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (3 * reps)
    del graph
    return ms


def kernel_label(ptxas_line: str) -> str:
    """'flash_fwd_bf16_kernel<64>' from ptxas's 'Compiling entry function'
    line (the mangled name of a kernel in an anonymous namespace: the
    source's hash, the name's length, the name, its template arguments)."""
    m = re.search(r"_cu_[0-9a-f]{8}(\d+)", ptxas_line)
    if m is None:
        return "?"
    rest = ptxas_line[m.end():]
    name, args = rest[:int(m.group(1))], rest[int(m.group(1)):]
    if not args.startswith("I"):
        return name
    args = args[1:].split("Ev")[0]
    kinds = (["bf16"] if "bfloat16" in args else []) + (["f32"] if args.startswith("f") else [])
    return f"{name}<{', '.join(kinds + re.findall(r'L[ib](\d+)E', args))}>"


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


# ---------------------------------------------------------------------------
# Kernel phase
# ---------------------------------------------------------------------------

def attn_bounds(q, k, q_lens, kv_lens, causal: bool
                ) -> dict[str, tuple[float, float]]:
    """(ms for the operations, ms for the bytes) of the forward, dQ and
    dK/dV kernels on this data, at the card's peaks. Operations: 4, 6 and
    8 * D FLOPs per valid (row, key) pair over the bf16 rate. Bytes: each
    input read once and each output written once, over the memory rate.
    The kernels read only the rows below q_len (q, dO, O, lse, delta) and
    kv_len (k, v) and write every row of their outputs (O, lse, dq, delta,
    dk, dv), so inputs count their valid rows and outputs their full size.
    dQ writes delta = rowsum(dO * O); dK/dV reads it instead of O. The
    least time the card could take is the larger of the two."""
    B, H, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    es = q.element_size()
    pairs = rows_q = rows_k = 0
    for ql, kl in zip(q_lens.tolist(), kv_lens.tolist()):
        ql, kl = min(max(ql, 0), Tq), min(max(kl, 0), Tk)
        rows_q, rows_k = rows_q + ql, rows_k + kl
        if not causal:
            pairs += ql * kl
        elif ql <= kl:
            pairs += ql * (ql + 1) / 2
        else:
            pairs += kl * (kl + 1) / 2 + (ql - kl) * kl
    q_in = rows_q * H * D * es            # one of q, dO, O (valid rows)
    kv_in = 2 * rows_k * Hkv * D * es     # k and v (valid rows)
    row_in = rows_q * H * 4               # one of lse, delta (valid rows)
    row_out = B * H * Tq * 4              # all of lse or delta
    nbytes = {"fwd": q_in + kv_in + q.numel() * es + row_out,
              # q, dO, O, k, v, lse in; dq and delta out
              "dq": 3 * q_in + kv_in + row_in + q.numel() * es + row_out,
              # q, dO, k, v, lse, delta in; dk and dv out
              "dkv": 2 * q_in + kv_in + 2 * row_in + 2 * k.numel() * es}
    flops = {"fwd": 4, "dq": 6, "dkv": 8}
    return {n: (flops[n] * H * D * pairs / PEAK_BF16_FLOPS * 1e3,
                nbytes[n] / PEAK_BYTES * 1e3) for n in flops}


def sdpa_ms(q, k, v, lens, causal: bool, do=None) -> dict:
    """Times of one PyTorch call that computes the kernel's function at
    uniform lengths ``lens`` (the forward; with ``do``, the backward of q,
    k and v together). Two calls are timed and the faster one is the
    yardstick: SDPA with the same boolean mask over the padded width (K/V
    repeated for GQA), which rules out the flash backend, and SDPA on the valid
    rows alone with ``is_causal`` and ``enable_gqa`` on the flash backend.
    Set-up (repeat, slices, the backward's forward) is not timed; each call
    is timed from a replayed CUDA graph (``graph_ms``), as the kernels are.
    The port never calls SDPA."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    B, H, T, _ = q.shape
    n = int(lens[0])
    check(bool((lens == n).all()), "the SDPA yardstick needs uniform lengths")
    idx = torch.arange(T, device=q.device)
    valid = idx[None, :] < lens[:, None]
    mask = valid[:, None, :, None] & valid[:, None, None, :]
    if causal:
        mask = mask & (idx[None, :] <= idx[:, None])
    G = H // k.shape[1]
    calls = {
        "masked": ((q, k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)),
                   dict(attn_mask=mask), contextlib.nullcontext),
        "flash": (tuple(t[:, :, :n].contiguous() for t in (q, k, v)),
                  dict(is_causal=causal, enable_gqa=True),
                  lambda: sdpa_kernel(SDPBackend.FLASH_ATTENTION)),
    }
    if q.shape[-1] > 256:
        del calls["flash"]        # PyTorch's flash backend takes head widths <= 256
    res = {}
    for name, (args, kw, backend) in calls.items():
        with backend():
            if do is None:
                res[name] = graph_ms([lambda: F.scaled_dot_product_attention(*args, **kw)])
                continue
            # the forward on the capture stream, so that its backward (which
            # autograd runs on the forward's stream) is captured too
            side = capture_stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                leaves = [t.detach().requires_grad_() for t in args]
                out = F.scaled_dot_product_attention(*leaves, **kw)
            torch.cuda.current_stream().wait_stream(side)
            g = do if name == "masked" else do[:, :, :n].contiguous()
            res[name] = graph_ms([lambda: torch.autograd.grad(out, leaves, g,
                                                              retain_graph=True)],
                                 reps=10)
    best = min(res, key=res.get)
    backend = ("FLASH_ATTENTION" if best == "flash"       # run under that backend alone
               else sdpa_backend(*calls["masked"][0], **calls["masked"][1]))
    return dict(ms=res[best], call=best, masked_ms=res["masked"],
                flash_ms=res.get("flash"), backend=backend)


def sdpa_backend(*args, **kw) -> str:
    """The backend SDPA picks for these arguments (PyTorch's own choice,
    ``torch._fused_sdp_choice``), by name."""
    import torch
    from torch.nn.attention import SDPBackend

    try:
        return SDPBackend(torch._fused_sdp_choice(*args, **kw)).name
    except (AttributeError, RuntimeError, TypeError, ValueError) as e:
        return f"not known ({type(e).__name__})"


def kernel_phase(seed: int, main_lens: dict[str, int]) -> list[dict]:
    import torch

    from avsr_tpu_torch.ops import attention as A

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    shapes = [
        # name, B, H, Hkv, T, causal
        ("whisper", 8, 16, 16, 512, False),
        ("llm_prefill", 8, 32, 8, 533, True),
    ]
    rows = []
    for name, B, H, Hkv, T, causal in shapes:
        D = 64
        q, k, v = (torch.randn((B, h, T, D), generator=gen, device=dev,
                               dtype=torch.bfloat16) for h in (H, Hkv, Hkv))
        ragged = rng.integers(T // 2, T + 1, B)
        ragged[0] = T
        lens_sets = {
            "ragged": torch.tensor(ragged, dtype=torch.int32, device=dev),
            "main": torch.full((B,), main_lens[name], dtype=torch.int32, device=dev),
        }
        err = lse_max = 0.0
        for tag, lens in lens_sets.items():
            o, lse = A.flash_attention(q, k, v, lens, lens, causal)
            o_r, lse_r = A.flash_attention_reference(q, k, v, lens, lens, causal)
            torch.cuda.synchronize()
            check(torch.isfinite(o.float()).all().item(), f"{name}/{tag}: O not finite")
            e = (o.float() - o_r.float()).abs()
            check(bool((e <= 2e-2 + 2e-2 * o_r.float().abs()).all()),
                  f"{name}/{tag}: O off by {e.max().item():.3e} (atol=rtol=2e-2)")
            fin = torch.isfinite(lse_r)
            check(torch.equal(fin, torch.isfinite(lse)),
                  f"{name}/{tag}: lse +inf rows differ")
            lse_err = (lse[fin] - lse_r[fin]).abs().max().item()
            check(lse_err <= 1e-3, f"{name}/{tag}: lse off by {lse_err:.3e} (atol 1e-3)")
            err = max(err, e.max().item())
            lse_max = max(lse_max, lse_err)
            print(f"kernel {name} [{tag} lens {lens.tolist()}]: max|dO| "
                  f"{e.max().item():.3e}, max|dlse| {lse_err:.3e}")

        lens = lens_sets["main"]
        ms = graph_ms([lambda: A.flash_attention(q, k, v, lens, lens, causal)])
        plain_ms = time_ms(
            lambda: A.flash_attention_reference(q, k, v, lens, lens, causal), 5)
        lib = sdpa_ms(q, k, v, lens, causal)
        ops_ms, bytes_ms = attn_bounds(q, k, lens, lens, causal)["fwd"]
        bound_ms = max(ops_ms, bytes_ms)
        bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
        row = dict(shape=name, q=list(q.shape), kv=list(k.shape), causal=causal,
                   lens=main_lens[name],
                   max_abs_err=err, max_lse_err=lse_max, ms=ms, plain_ms=plain_ms,
                   library_ms=lib["ms"], library=lib, bound_ms=bound_ms,
                   bound_by=bound_by, ops_ms=ops_ms, bytes_ms=bytes_ms)
        print(f"kernel {name}: {ms:.4f} ms (plain {plain_ms:.4f}, SDPA "
              f"{lib['ms']:.4f} [{lib['call']}; masked {lib['masked_ms']:.4f}, "
              f"flash {lib['flash_ms']:.4f}], bound {bound_ms:.4f} by {bound_by})")
        rows.append(row)

    # Edge cases off the main path: f32 with D=128, GQA, an empty row.
    q, k, v = (torch.randn((2, h, 300, 128), generator=gen, device=dev)
               for h in (4, 2, 2))
    for causal, ql, kl in ((True, [300, 0], [300, 0]), (False, [300, 131], [300, 0])):
        ql_t = torch.tensor(ql, device=dev)
        kl_t = torch.tensor(kl, device=dev)
        o, lse = A.flash_attention(q, k, v, ql_t, kl_t, causal)
        o_r, lse_r = A.flash_attention_reference(q, k, v, ql_t, kl_t, causal)
        torch.cuda.synchronize()
        e = (o - o_r).abs().max().item()
        fin = torch.isfinite(lse_r)
        check(e <= 1e-4 and torch.equal(fin, torch.isfinite(lse))
              and (lse[fin] - lse_r[fin]).abs().max().item() <= 1e-4,
              f"f32 D=128 edge case (causal={causal}) off by {e:.3e}")
        check(bool((o[1] == 0).all()), "rows without keys must be zero")
    print("kernel f32/D=128/empty-row edge cases: ok")
    return rows


# ---------------------------------------------------------------------------
# Main-path phase
# ---------------------------------------------------------------------------

def serving_host_batch(cfg, seed: int, B: int = 8, n_samples: int = 160_000,
                       n_frames: int = 25, size: int = 224):
    """B utterances of 10 s audio and 25 frames of ``size`` px from
    ``seed``, collated on the host (the serving phases' input)."""
    from avsr_tpu_torch.data.dataset import Sample
    from avsr_tpu_torch.data.loader import collate
    from avsr_tpu_torch.data.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    rng = np.random.default_rng(seed)
    t = np.arange(n_samples, dtype=np.float32) / 16000.0
    samples = []
    for i in range(B):
        audio = (0.3 * np.sin(2 * np.pi * rng.uniform(80, 300) * t)
                 + 0.05 * rng.standard_normal(n_samples)).astype(np.float32)
        frames = rng.integers(0, 256, (n_frames, size, size, 3), dtype=np.uint8)
        samples.append(Sample(f"smoke/{i}", audio, frames, "", [tok.eos_id]))
    return collate(samples, cfg.data, tok.encode(cfg.model.prompt, add_bos=True),
                   tok.pad_id)


def reset_counts() -> None:
    from avsr_tpu_torch.ops import attention as A
    from avsr_tpu_torch.ops import qmatmul as Q

    A.launches = A.dq_launches = A.dkv_launches = 0
    Q.int8_launches = Q.int4_launches = 0


def main_path_phase(seed: int) -> dict:
    import torch

    from avsr_tpu_torch.convert import cast_tree, param_count
    from avsr_tpu_torch.core.config import flagship
    from avsr_tpu_torch.data.loader import featurize
    from avsr_tpu_torch.infer.generate import generate_tokens
    from avsr_tpu_torch.models.avsr import encode, init_avsr_model
    from avsr_tpu_torch.ops import attention as A
    from avsr_tpu_torch.ops import qmatmul as Q

    cfg = flagship()
    mc = cfg.model
    B, n_samples, n_frames, new = 8, 160_000, 25, cfg.decode.max_new_tokens
    t0 = time.perf_counter()
    params = init_avsr_model(mc, seed=seed, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = param_count(params)
    print(f"main path: random init of {n_params / 1e9:.3f} B params (bf16) "
          f"in {time.perf_counter() - t0:.2f} s")

    hb = serving_host_batch(cfg, seed, B, n_samples, n_frames)
    batch = featurize(hb, "cuda", torch.bfloat16)
    tp = hb.prompt.shape[1]
    check(batch.mel.shape == (B, 80, 1000), f"mel shape {tuple(batch.mel.shape)}")
    check(batch.frames.shape == (B, n_frames, 3, 224, 224), "frames shape")

    kw = dict(max_new_tokens=new, eos_id=-1, compute_dtype=torch.bfloat16)
    generate_tokens(params, mc, batch, **{**kw, "max_new_tokens": 4})  # warm-up

    expected = mc.whisper.n_layers + mc.llm.n_layers
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    st: dict = {}
    out = generate_tokens(params, mc, batch, stats=st, **kw)
    launches = A.launches
    check(A.dq_launches == A.dkv_launches == 0,
          "the serving path launched a backward kernel")
    check(Q.int8_launches == Q.int4_launches == 0,
          "the bf16 serving path launched a qmatmul kernel")
    peak = torch.cuda.max_memory_allocated()
    print(f"main path: flash_fwd launches in one generate_tokens call: "
          f"{launches} (expected {mc.whisper.n_layers} Whisper + "
          f"{mc.llm.n_layers} LLM = {expected})")
    check(launches == expected, f"flash_fwd launched {launches} times, not {expected}")
    # the encoders' own share of them: one encode call on the same batch
    reset_counts()
    with torch.no_grad():
        encode(params, mc, batch, compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    enc_launches = A.launches
    check(enc_launches == mc.whisper.n_layers,
          f"encode launched flash_fwd {enc_launches} times, not {mc.whisper.n_layers}")

    st_never: dict = {}
    out_never = generate_tokens(params, mc, batch, stats=st_never,
                                use_kernel="never", **kw)
    lk, ln = st["prefill_logits"], st_never["prefill_logits"]
    check(bool(torch.isfinite(lk).all()), "prefill logits not finite")

    # The same weights and inputs in float32, kernel path against plain
    # path: what the kernel changes without bf16 rounding noise.
    p32 = cast_tree(params, torch.float32)
    b32 = featurize(hb, "cuda", torch.float32)
    kw32 = dict(max_new_tokens=1, eos_id=-1, compute_dtype=torch.float32)
    s32k: dict = {}
    s32n: dict = {}
    generate_tokens(p32, mc, b32, stats=s32k, **kw32)
    generate_tokens(p32, mc, b32, stats=s32n, use_kernel="never", **kw32)
    del p32, b32
    ref = s32n["prefill_logits"]          # the most exact logits of the run
    std = ref.std().item()

    def dist(a, b):
        d = (a - b).abs()
        return dict(max=d.max().item(), mean=d.mean().item(),
                    top1_agree=(a.argmax(-1) == b.argmax(-1)).float().mean().item())

    cmp = dict(std_f32=std,
               f32_kernel_vs_plain=dist(s32k["prefill_logits"], ref),
               bf16_kernel_vs_plain=dist(lk, ln),
               bf16_kernel_vs_f32=dist(lk, ref),
               bf16_plain_vs_f32=dist(ln, ref))
    print("main path: prefill logits " + json.dumps(cmp))
    d32 = cmp["f32_kernel_vs_plain"]["max"]
    check(d32 <= 2e-2 * std,
          f"f32 prefill logits: kernel vs plain max|d| {d32:.4e} > 2e-2 * std {std:.4e}")
    # In bf16 each path rounds differently at every layer (the kernel also
    # rounds P to bf16 before PV), so the two drift apart through 40 layers;
    # hold the kernel path to the plain path's own distance from f32.
    ek, en = cmp["bf16_kernel_vs_f32"]["mean"], cmp["bf16_plain_vs_f32"]["mean"]
    check(ek <= 2.0 * en,
          f"bf16 prefill logits: kernel path mean|d| to f32 {ek:.4e} > 2x the "
          f"plain path's {en:.4e}")
    agree = (out.tokens == out_never.tokens).float().mean().item()
    check(out.tokens.shape == (B, new), f"tokens shape {tuple(out.tokens.shape)}")
    check(bool(((out.tokens >= 0) & (out.tokens < mc.llm.vocab_size)).all()),
          "token ids out of range")
    check(bool((out.lengths == new).all()), "eos_id=-1 must run every step")

    steps = st["decode_steps"]
    res = dict(
        batch=B, audio_s=n_samples / 16000, video_frames=n_frames,
        prefix_len=tp + (1000 + 1) // 2, prompt_tokens=tp, max_new_tokens=new,
        encode_ms=st["encode_s"] * 1e3, prefill_ms=st["prefill_s"] * 1e3,
        decode_ms=st["decode_s"] * 1e3, decode_steps=steps,
        ms_per_token=st["decode_s"] * 1e3 / steps,
        decode_tokens_per_s=B * steps / st["decode_s"],
        new_tokens_per_s=B * new / (st["encode_s"] + st["prefill_s"] + st["decode_s"]),
        peak_mem_gb=peak / 1e9, flash_launches=launches,
        flash_launches_by_shape={"whisper": enc_launches,
                                 "llm_prefill": launches - enc_launches},
        prefill_logits=cmp, token_agreement_bf16_kernel_vs_plain=agree,
        plain_path=dict(encode_ms=st_never["encode_s"] * 1e3,
                        prefill_ms=st_never["prefill_s"] * 1e3,
                        ms_per_token=st_never["decode_s"] * 1e3 / steps))
    print("main path: " + json.dumps(res))
    return res


# ---------------------------------------------------------------------------
# qmatmul kernel phase
# ---------------------------------------------------------------------------

# name, bits, K, N, launches in one generate_tokens call of each serving
# path: per decode step 16 layers x qkv, o, gateup, down (int4 in the
# preset, int8 in the use_8bit call) and the int8 head, which also runs once
# at the prefill's last position.
def qmm_shapes(n_layers: int, steps: int) -> list[tuple]:
    proj = n_layers * steps
    head = {"serve_preset": steps + 1, "serve_8bit": steps + 1}
    return [("qkv", 4, 2048, 3072, {"serve_preset": proj}),
            ("o", 4, 2048, 2048, {"serve_preset": proj}),
            ("gateup", 4, 2048, 16384, {"serve_preset": proj}),
            ("down", 4, 8192, 2048, {"serve_preset": proj}),
            ("lm_head", 8, 2048, 129024, head),
            ("qkv", 8, 2048, 3072, {"serve_8bit": proj}),
            ("o", 8, 2048, 2048, {"serve_8bit": proj}),
            ("gateup", 8, 2048, 16384, {"serve_8bit": proj}),
            ("down", 8, 8192, 2048, {"serve_8bit": proj})]


def qmm_bound(M: int, K: int, N: int, bits: int) -> tuple[float, float]:
    """(ms for the operations, ms for the bytes) of one launch: 2 M K N
    FLOPs at the bf16 rate; the packed weight, the f32 scale, the bf16 x and
    the f32 output, each once, at the memory rate."""
    nbytes = K * N * bits // 8 + 4 * N + 2 * M * K + 4 * M * N
    return 2 * M * K * N / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3


def qmm_row(name: str, bits: int, M: int, K: int, N: int, by_call: dict,
            gen) -> dict:
    """One weight-only matmul shape: the kernel against its plain version,
    and the device times of the kernel, its plain version, one bf16 matmul
    on the dequantized weight and the dequantize-then-matmul pair, each
    from a replayed CUDA graph with the weights cycled through more memory
    than the L2 holds (as in a decode step), beside the bound and the
    launch plan."""
    import torch

    from avsr_tpu_torch.ops import qmatmul as Q
    from avsr_tpu_torch.ops import quant

    dev = "cuda"
    l2_bytes = 128e6
    qp = quant.quantize_tensor(0.02 * torch.randn((K, N), generator=gen, device=dev), bits)
    x = torch.randn((M, K), generator=gen, device=dev, dtype=torch.bfloat16)
    y = Q.qmatmul(x, qp)
    ref = Q.qmatmul_reference(x, qp)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(y).all()), f"qmatmul {name} int{bits} M={M}: not finite")
    err = (y - ref).abs().max().item()
    rel = err / ref.abs().max().item()
    check(rel <= 1e-4, f"qmatmul {name} int{bits} M={M}: max|d| {err:.3e} = {rel:.3e} "
                       f"x max|ref| > 1e-4")
    wkey = "qw4h" if bits == 4 else "qw"
    wbytes = qp[wkey].numel()
    nodes = [qp] + [{wkey: qp[wkey].clone(), "scale": qp["scale"].clone()}
                    for _ in range(int(np.ceil(l2_bytes / wbytes)) - 1)]
    ms = graph_ms([lambda n=n: Q.qmatmul(x, n) for n in nodes])
    w16 = quant.dequantize(qp, torch.bfloat16)
    w16s = [w16] + [w16.clone() for _ in range(int(np.ceil(l2_bytes / (2 * wbytes))) - 1)]
    library_ms = graph_ms([lambda w=w: torch.matmul(x, w) for w in w16s])
    pair_ms = graph_ms([lambda n=n: torch.matmul(x, quant.dequantize(n, torch.bfloat16))
                        for n in nodes])
    plain_ms = graph_ms([lambda n=n: Q.qmatmul_reference(x, n) for n in nodes])
    del nodes, w16, w16s
    ops_ms, bytes_ms = qmm_bound(M, K, N, bits)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = dict(zip(("splits", "rows_per_cta", "n8_tiles"),
                    Q.int4_plan(M, K // 2, N, sms) if bits == 4 else Q.int8_plan(M, K, N, sms)))
    row = dict(shape=name, bits=bits, M=M, K=K, N=N,
               launches_per_call=max(by_call.values(), default=0), launches_by_call=by_call,
               max_abs_err=err, max_rel_err=rel, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, dequant_matmul_ms=pair_ms,
               bound_ms=max(ops_ms, bytes_ms), ops_ms=ops_ms, bytes_ms=bytes_ms,
               bound_by="operations" if ops_ms >= bytes_ms else "bytes", plan=plan)
    print(f"qmatmul {name} int{bits} [{M}x{K}] x [{K}x{N}]: {ms * 1e3:.2f} us "
          f"(bound {row['bound_ms'] * 1e3:.2f} by {row['bound_by']}, plain "
          f"{plain_ms * 1e3:.1f}, bf16 matmul {library_ms * 1e3:.2f}, dequant + "
          f"matmul {pair_ms * 1e3:.1f}; {plan}); max|d| "
          f"{err:.3e} = {rel:.2e} x max|ref|")
    return row


def qmm_kernel_phase(seed: int, n_layers: int, steps: int) -> dict:
    import torch

    from avsr_tpu_torch.ops import qmatmul as Q
    from avsr_tpu_torch.ops import quant

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    rows = [qmm_row(name, bits, 8, K, N, by_call, gen)
            for name, bits, K, N, by_call in qmm_shapes(n_layers, steps)]

    # Edge cases off the main path: ragged M (9 and 17 take two n8 tiles of
    # x, 17 also two units along M), f32 x, N and K off the tile (N = 2050
    # is not even a multiple of 4 and N = 1000 not of 16: the byte-load
    # paths; K = 1000 is not a multiple of the int8 kernel's 16-row k step
    # and K/2 = 500 not of the int4 kernel's 8-row one), bf16 output, and a
    # K that does not match the weight.
    edge = 0.0
    for bits in (8, 4):
        for M, K, N, xdt, odt in ((1, 2048, 3072, torch.bfloat16, torch.float32),
                                  (5, 2048, 3072, torch.bfloat16, torch.float32),
                                  (9, 2048, 3072, torch.bfloat16, torch.float32),
                                  (17, 8192, 2048, torch.bfloat16, torch.float32),
                                  (17, 1000, 2050, torch.float32, torch.float32),
                                  (64, 2048, 3072, torch.bfloat16, torch.float32),
                                  (8, 2048, 3072, torch.float32, torch.float32),
                                  (8, 1000, 2050, torch.bfloat16, torch.float32),
                                  (7, 1000, 1000, torch.float32, torch.bfloat16)):
            qp = quant.quantize_tensor(torch.randn((K, N), generator=gen, device=dev), bits)
            qp["scale"] = qp["scale"].to(torch.bfloat16)       # as cast_frozen leaves it
            x = torch.randn((M, K), generator=gen, device=dev).to(xdt)
            y = Q.qmatmul(x, qp, out_dtype=odt)
            ref = Q.qmatmul_reference(x, qp)
            torch.cuda.synchronize()
            rel = ((y.float() - ref).abs().max() / ref.abs().max()).item()
            tol = 1e-4 if odt == torch.float32 else 2 ** -8    # one bf16 rounding
            check(y.shape == (M, N) and y.dtype == odt and rel <= tol,
                  f"qmatmul edge int{bits} M={M} K={K} N={N} x {xdt} out {odt}: "
                  f"{rel:.3e} x max|ref|")
            if odt == torch.float32:
                edge = max(edge, rel)
        try:
            Q.qmatmul(torch.zeros((8, 2048 + 2), device=dev, dtype=torch.bfloat16), qp)
        except ValueError:
            pass
        else:
            raise CheckFailed(f"int{bits}: an x whose K does not match did not raise")
    print(f"qmatmul edge cases (M 1/5/9/17/64, f32 x, N 2050/1000, K 1000, bf16 "
          f"out, K mismatch): ok, worst f32 max|d| {edge:.3e} x max|ref|")

    # The same bits on every run: two launches, and a CUDA graph of one
    # replayed twice (the last CTA of a tile adds its K split in split
    # order; neither kernel adds by float atomics).
    for bits, M, K, N in ((4, 8, 2048, 3072), (4, 8, 8192, 2048), (4, 17, 1000, 2050),
                          (8, 8, 2048, 3072), (8, 8, 2048, 2048), (8, 8, 8192, 2048),
                          (8, 8, 2048, 129024), (8, 17, 1000, 2050)):
        qp = quant.quantize_tensor(torch.randn((K, N), generator=gen, device=dev), bits)
        x = torch.randn((M, K), generator=gen, device=dev, dtype=torch.bfloat16)
        runs = [Q.qmatmul(x, qp), Q.qmatmul(x, qp)]
        side = capture_stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            Q.qmatmul(x, qp)      # the stream's counters exist before the capture
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            captured = Q.qmatmul(x, qp)
        for _ in range(2):
            graph.replay()
            torch.cuda.synchronize()
            runs.append(captured.clone())
        del graph
        check(all(torch.equal(runs[0], r) for r in runs[1:]),
              f"qmatmul int{bits} M={M} K={K} N={N}: launches on the same inputs differ")
    print("qmatmul determinism (two launches and two graph replays, int4 at qkv, "
          "down and M=17 K=1000 N=2050, int8 at qkv, o, down, the head and M=17 "
          "K=1000 N=2050): bit-identical")
    return dict(rows=rows, edge_max_rel_err=edge, deterministic=True)


# ---------------------------------------------------------------------------
# Serving-preset phase
# ---------------------------------------------------------------------------

def decode_step_logits(params, mc, hb, dtype, use_kernels, nxt=None):
    """One prefill (kernels on) into an int8 cache, then one decode step
    per ``use_kernels`` entry on copies of that cache: {use_kernel: logits
    [B, V] f32}, and the step's input token (the greedy one of the
    prefill unless ``nxt`` is given)."""
    import torch

    from avsr_tpu_torch.data.loader import featurize
    from avsr_tpu_torch.models import llama as L
    from avsr_tpu_torch.models.avsr import build_prefix, encode

    lora = mc.lora if mc.lora.use_lora else None
    with torch.inference_mode():
        batch = featurize(hb, "cuda", dtype)
        enc = encode(params, mc, batch, compute_dtype=dtype, moe_rowwise=True)
        prefix, lens = build_prefix(params, mc, batch, enc, compute_dtype=dtype)
        B, T = prefix.shape[:2]
        hidden, cache = L.llama_apply(
            params["llm"], mc.llm, inputs_embeds=prefix, lengths=lens, lora=lora,
            compute_dtype=dtype, return_cache=True, cache_len=-(-(T + 2) // 128) * 128,
            output="hidden", moe_rowwise=True)
        cache = L.quantize_cache(cache)
        if nxt is None:
            h_last = hidden[torch.arange(B, device=prefix.device), lens.long() - 1][:, None]
            nxt = L.compute_logits(params["llm"], mc.llm, h_last, "never")[:, 0].argmax(-1)
        emb = L.embed_tokens(params["llm"], nxt[:, None], dtype)
        out = {}
        for uk in use_kernels:
            c = L.KVCache(*(t.clone() for t in cache))
            out[uk] = L.llama_decode_step(params["llm"], mc.llm, x=emb, cache=c,
                                          cur_lens=lens.long(), lora=lora,
                                          compute_dtype=dtype, use_kernel=uk)[0]
    return out, nxt


def preset_phase(seed: int, bf16: dict, qmm: dict, overrides=PRESET_OVERRIDES,
                 tag: str = "preset", against_bf16_weights: bool = True) -> dict:
    """One generate_tokens call of the flagship with ``overrides`` (a
    quantized serving path): exact launch counts, decode-step logit gates,
    serving numbers; with ``against_bf16_weights``, also the same weights
    unquantized."""
    import torch

    from avsr_tpu_torch.cli.common import load_decode_params
    from avsr_tpu_torch.convert import cast_tree
    from avsr_tpu_torch.core.config import flagship
    from avsr_tpu_torch.data.loader import featurize
    from avsr_tpu_torch.infer.generate import generate_tokens
    from avsr_tpu_torch.ops import attention as A
    from avsr_tpu_torch.ops import qmatmul as Q
    from avsr_tpu_torch.ops.quant import quant_bytes

    cfg = flagship(list(overrides))
    mc = cfg.model
    new = cfg.decode.max_new_tokens
    proj_bits = 4 if mc.use_4bit else 8
    t0 = time.perf_counter()
    params = load_decode_params(cfg, seed=seed, device="cuda")
    torch.cuda.synchronize()
    llm_gb = quant_bytes(params["llm"]) / 1e9
    print(f"{tag}: f32 init, int{proj_bits} quantization, bf16 cast and decode layout "
          f"in {time.perf_counter() - t0:.2f} s; LLM tree {llm_gb:.3f} GB")
    hb = serving_host_batch(cfg, seed)
    batch = featurize(hb, "cuda", torch.bfloat16)
    kw = dict(max_new_tokens=new, eos_id=-1, compute_dtype=torch.bfloat16,
              kv_cache_dtype=cfg.decode.kv_cache_dtype)
    generate_tokens(params, mc, batch, **{**kw, "max_new_tokens": 4})   # warm-up

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    st: dict = {}
    out = generate_tokens(params, mc, batch, stats=st, **kw)
    counts = dict(flash_fwd=A.launches, flash_bwd_dq=A.dq_launches,
                  flash_bwd_dkv=A.dkv_launches, qmatmul_int8=Q.int8_launches,
                  qmatmul_int4=Q.int4_launches)
    peak = torch.cuda.max_memory_allocated()
    steps = st["decode_steps"]
    proj = 4 * mc.llm.n_layers * steps      # qkv, o, gateup, down per layer and step
    want = dict(flash_fwd=mc.whisper.n_layers + mc.llm.n_layers, flash_bwd_dq=0,
                flash_bwd_dkv=0,
                qmatmul_int8=steps + 1 + (proj if proj_bits == 8 else 0),
                qmatmul_int4=proj if proj_bits == 4 else 0)
    print(f"{tag}: launches in one generate_tokens call {counts} (expected {want})")
    check(counts == want, f"{tag} launches {counts}, expected {want}")
    B = batch.mel.shape[0]
    check(out.tokens.shape == (B, new) and bool((out.lengths == new).all()),
          f"{tag} tokens")
    check(bool(((out.tokens >= 0) & (out.tokens < mc.llm.vocab_size)).all()),
          f"{tag} token ids out of range")
    check(bool(torch.isfinite(st["prefill_logits"]).all()), f"{tag} logits not finite")

    # Decode-step logits, kernel path against the dequantize path. In f32
    # the kernels still round x to bf16 (65 products per step) and the
    # dequantize path does not: mean |d| within 1e-2 * std, and max |d| no
    # larger than running the whole step in bf16 moves the logits. In bf16
    # the kernel path is no further from the f32 dequantize logits than 2x
    # the bf16 dequantize path is.
    p32 = cast_tree(params, torch.float32)
    l32, nxt = decode_step_logits(p32, mc, hb, torch.float32, ("auto", "never"))
    del p32
    torch.cuda.empty_cache()
    l16, _ = decode_step_logits(params, mc, hb, torch.bfloat16, ("auto", "never"), nxt)
    ref = l32["never"]
    std = ref.std().item()
    d32 = (l32["auto"] - ref).abs()
    dk, dn = (l16["auto"] - ref).abs(), (l16["never"] - ref).abs()
    step_cmp = dict(std_f32=std, f32_kernel_vs_dequant_max=d32.max().item(),
                    f32_kernel_vs_dequant_mean=d32.mean().item(),
                    f32_mean_ratio_to_std=d32.mean().item() / std,
                    bf16_kernel_vs_f32_mean=dk.mean().item(),
                    bf16_dequant_vs_f32_mean=dn.mean().item(),
                    bf16_kernel_vs_f32_max=dk.max().item(),
                    bf16_dequant_vs_f32_max=dn.max().item(),
                    top1_f32_kernel_vs_dequant=(l32["auto"].argmax(-1) == ref.argmax(-1))
                    .float().mean().item())
    print(f"{tag} decode-step logits " + json.dumps(step_cmp))
    c = step_cmp
    check(c["f32_kernel_vs_dequant_mean"] <= 1e-2 * std,
          f"{tag} f32 decode step: kernel vs dequant mean|d| "
          f"{c['f32_kernel_vs_dequant_mean']:.4e} > 1e-2 * std {std:.4e}")
    check(c["f32_kernel_vs_dequant_max"] <= c["bf16_dequant_vs_f32_max"],
          f"{tag} f32 decode step: kernel vs dequant max|d| "
          f"{c['f32_kernel_vs_dequant_max']:.4e} > the bf16 step's own "
          f"{c['bf16_dequant_vs_f32_max']:.4e}")
    check(c["bf16_kernel_vs_f32_mean"] <= 2.0 * c["bf16_dequant_vs_f32_mean"],
          f"{tag} bf16 decode step: kernel path mean|d| to f32 "
          f"{c['bf16_kernel_vs_f32_mean']:.4e} > 2x the dequantize path's "
          f"{c['bf16_dequant_vs_f32_mean']:.4e}")
    del l32, l16

    shapes = {(r["shape"], r["bits"]): r for r in qmm["rows"]}
    per_step = {key: mc.llm.n_layers * sum(shapes[(n, proj_bits)][key]
                                           for n in ("qkv", "o", "gateup", "down"))
                + shapes[("lm_head", 8)][key]
                for key in ("ms", "bound_ms", "library_ms", "plain_ms")}
    ms_tok = st["decode_s"] * 1e3 / steps
    res = dict(
        config="flagship + " + " ".join(overrides), batch=B, max_new_tokens=new,
        encode_ms=st["encode_s"] * 1e3, prefill_ms=st["prefill_s"] * 1e3,
        decode_ms=st["decode_s"] * 1e3, decode_steps=steps, ms_per_token=ms_tok,
        decode_tokens_per_s=B * steps / st["decode_s"],
        new_tokens_per_s=B * new / (st["encode_s"] + st["prefill_s"] + st["decode_s"]),
        peak_mem_gb=peak / 1e9, llm_tree_gb=llm_gb, launches=counts,
        decode_step_logits=step_cmp,
        bf16_phase=dict(encode_ms=bf16["encode_ms"], prefill_ms=bf16["prefill_ms"],
                        ms_per_token=bf16["ms_per_token"],
                        new_tokens_per_s=bf16["new_tokens_per_s"],
                        peak_mem_gb=bf16["peak_mem_gb"]),
        qmatmul_per_step=dict(**per_step, share_of_step=per_step["ms"] / ms_tok))
    if against_bf16_weights:
        # The same random weights unquantized (one f32 init from the seed):
        # how far the quantized path's greedy choices move.
        pb = load_decode_params(flagship(), seed=seed, device="cuda")
        stb: dict = {}
        outb = generate_tokens(pb, mc, batch, stats=stb,
                               **{**kw, "kv_cache_dtype": "bfloat16"})
        del pb
        torch.cuda.empty_cache()
        lq, lb = st["prefill_logits"], stb["prefill_logits"]
        res.update(
            prefill_top1_vs_bf16_weights=(lq.argmax(-1) == lb.argmax(-1)).float().mean().item(),
            prefill_logits_corr_vs_bf16_weights=torch.corrcoef(
                torch.stack([lq.flatten(), lb.flatten()]))[0, 1].item(),
            token_agreement_vs_bf16_weights=(out.tokens == outb.tokens).float().mean().item(),
            bf16_weights_same_init=dict(
                encode_ms=stb["encode_s"] * 1e3, prefill_ms=stb["prefill_s"] * 1e3,
                ms_per_token=stb["decode_s"] * 1e3 / stb["decode_steps"]))
    print(f"{tag}: " + json.dumps(res))
    return res


# ---------------------------------------------------------------------------
# Backward kernel phase
# ---------------------------------------------------------------------------

def rel_err(a, ref) -> float:
    """max|a - ref| / max|ref| (f32)."""
    return ((a.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp(min=1e-30)).item()


def bwd_kernel_phase(seed: int, main_len: int) -> dict:
    import torch

    from avsr_tpu_torch.ops import attention as A

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    rng = np.random.default_rng(seed + 1)
    # the LLM attention of one train micro-batch: 8 rows packed to 672
    B, H, Hkv, T, D = 8, 32, 8, 672, 64
    q, do = (torch.randn((B, H, T, D), generator=gen, device=dev,
                         dtype=torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((B, Hkv, T, D), generator=gen, device=dev,
                        dtype=torch.bfloat16) for _ in range(2))
    ragged = rng.integers(T // 2, T + 1, B)
    ragged[0] = T
    lens_sets = {"ragged": torch.tensor(ragged, dtype=torch.int32, device=dev),
                 "main": torch.full((B,), main_len, dtype=torch.int32, device=dev)}
    errs = {"dq": 0.0, "dk": 0.0, "dv": 0.0}
    abs_errs = dict(errs)
    for tag, lens in lens_sets.items():
        o, lse = A.flash_attention(q, k, v, lens, lens, True)
        dq, delta = A.flash_bwd_dq(q, k, v, o, lse, do, lens, lens, True)
        dk, dv = A.flash_bwd_dkv(q, k, v, lse, delta, do, lens, lens, True)
        refs = A.flash_attention_bwd_reference(q, k, v, o, lse, do, lens, lens, True)
        delta_r = A.flash_bwd_dq_reference(q, k, v, o, lse, do, lens, lens, True)[1]
        torch.cuda.synchronize()
        d_err = (delta - delta_r).abs().max().item()
        check(d_err <= 1e-4 * max(1.0, delta_r.abs().max().item()),
              f"bwd {tag}: delta off by {d_err:.3e}")
        for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
            check(bool(torch.isfinite(got.float()).all()), f"bwd {tag}: {name} not finite")
            e = rel_err(got, ref)
            check(e <= 2e-2, f"bwd {tag}: {name} max|d| {e:.3e} x max|ref| > 2e-2")
            errs[name] = max(errs[name], e)
            abs_errs[name] = max(abs_errs[name],
                                 (got.float() - ref.float()).abs().max().item())
        print(f"bwd kernels [{tag} lens {lens.tolist()}]: max|d|/max|ref| "
              + ", ".join(f"{n} {rel_err(g, r):.3e}"
                          for n, g, r in zip(("dq", "dk", "dv"), (dq, dk, dv), refs)))

    # Edge cases off the main path: f32, D=128, GQA, an empty row, Tq != Tk.
    qe, doe = (torch.randn((2, 4, 300, 128), generator=gen, device=dev)
               for _ in range(2))
    ke, ve = (torch.randn((2, 2, 300, 128), generator=gen, device=dev)
              for _ in range(2))
    for causal, ql, kl, tk in ((True, [300, 0], [300, 0], 300),
                               (False, [300, 131], [300, 0], 300),
                               (False, [257, 100], [290, 17], 290)):
        kk, vv = ke[:, :, :tk].contiguous(), ve[:, :, :tk].contiguous()
        qq, dd = qe[:, :, :ql[0]].contiguous(), doe[:, :, :ql[0]].contiguous()
        ql_t, kl_t = torch.tensor(ql, device=dev), torch.tensor(kl, device=dev)
        o, lse = A.flash_attention(qq, kk, vv, ql_t, kl_t, causal)
        dq_e, delta_e = A.flash_bwd_dq(qq, kk, vv, o, lse, dd, ql_t, kl_t, causal)
        got = (dq_e, *A.flash_bwd_dkv(qq, kk, vv, lse, delta_e, dd, ql_t, kl_t, causal))
        refs = A.flash_attention_bwd_reference(qq, kk, vv, o, lse, dd, ql_t,
                                               kl_t, causal)
        torch.cuda.synchronize()
        for name, g, r in zip(("dq", "dk", "dv"), got, refs):
            e = rel_err(g, r)
            check(e <= 1e-4, f"f32 D=128 bwd edge case (causal={causal}, "
                             f"lens {ql}/{kl}): {name} off by {e:.3e} x max|ref|")
        check(bool((got[0][1, :, ql[1]:] == 0).all()), "dq rows past q_len must be 0")
    print("bwd kernels f32/D=128/GQA/empty-row/cross edge cases: ok")

    # The autograd Function against autograd through the plain attention.
    qf, kf, vf = (torch.randn((2, h, 320, 64), generator=gen, device=dev)
                  for h in (4, 2, 2))
    gf = torch.randn((2, 4, 320, 64), generator=gen, device=dev)
    lf = torch.tensor([320, 250], device=dev)
    grads = []
    for fn in (lambda q_, k_, v_: A.FlashAttention.apply(q_, k_, v_, lf, lf, True, None),
               lambda q_, k_, v_: A.mha_reference(q_, k_, v_, causal=True,
                                                  q_lens=lf, kv_lens=lf)):
        leaves = [t.clone().requires_grad_() for t in (qf, kf, vf)]
        fn(*leaves).backward(gf)
        grads.append([t.grad for t in leaves])
    fn_err = max(rel_err(a, b) for a, b in zip(*grads))
    check(fn_err <= 1e-4, f"FlashAttention grads off autograd by {fn_err:.3e}")
    print(f"FlashAttention vs autograd through mha_reference (f32): {fn_err:.3e}")

    # Times at the main-path lengths (bf16), kernels from replayed CUDA
    # graphs, plain versions eager (they take milliseconds).
    lens = lens_sets["main"]
    o, lse = A.flash_attention(q, k, v, lens, lens, True)
    _, delta = A.flash_bwd_dq(q, k, v, o, lse, do, lens, lens, True)
    args_dq = (q, k, v, o, lse, do, lens, lens, True)
    args_dkv = (q, k, v, lse, delta, do, lens, lens, True)
    times = {
        "fwd": graph_ms([lambda: A.flash_attention(q, k, v, lens, lens, True)]),
        "dq": graph_ms([lambda: A.flash_bwd_dq(*args_dq)]),
        "dkv": graph_ms([lambda: A.flash_bwd_dkv(*args_dkv)]),
    }
    # the causal imbalance of dK/dV: the same shape without the mask does
    # twice the pairs, so a balanced causal run would take half its time
    o_nc, lse_nc = A.flash_attention(q, k, v, lens, lens, False)
    _, delta_nc = A.flash_bwd_dq(q, k, v, o_nc, lse_nc, do, lens, lens, False)
    dkv_noncausal_ms = graph_ms([lambda: A.flash_bwd_dkv(
        q, k, v, lse_nc, delta_nc, do, lens, lens, False)])
    del o_nc, lse_nc, delta_nc
    plain = {
        "fwd": time_ms(lambda: A.flash_attention_reference(q, k, v, lens, lens, True), 3),
        "dq": time_ms(lambda: A.flash_bwd_dq_reference(*args_dq), 3),
        "dkv": time_ms(lambda: A.flash_bwd_dkv_reference(*args_dkv), 3),
    }
    # library yardstick: the SDPA backward of q, k, v together
    library_bwd = sdpa_ms(q, k, v, lens, True, do)
    library_fwd = sdpa_ms(q, k, v, lens, True)
    bounds = attn_bounds(q, k, lens, lens, True)
    res = {"shape": dict(q=list(q.shape), kv=list(k.shape), causal=True,
                         lens=main_len, dtype="bfloat16"),
           "max_rel_err": errs, "max_abs_err": abs_errs, "edge_fn_err": fn_err,
           "library_bwd_pair": library_bwd, "library_fwd": library_fwd,
           "dkv_noncausal_ms": dkv_noncausal_ms}
    for name in ("fwd", "dq", "dkv"):
        ops_ms, bytes_ms = bounds[name]
        res[name] = dict(ms=times[name], plain_ms=plain[name],
                         bound_ms=max(ops_ms, bytes_ms), ops_ms=ops_ms,
                         bytes_ms=bytes_ms,
                         bound_by="operations" if ops_ms >= bytes_ms else "bytes")
        print(f"kernel {name} at the train shape: {times[name]:.4f} ms (plain "
              f"{plain[name]:.4f}, bound {res[name]['bound_ms']:.4f} by "
              f"{res[name]['bound_by']})")
    print(f"kernel dkv at the train shape without the causal mask: "
          f"{dkv_noncausal_ms:.4f} ms (half: {dkv_noncausal_ms / 2:.4f}; causal "
          f"{times['dkv']:.4f})")
    for what, lib in (("forward", library_fwd), ("backward of q, k, v", library_bwd)):
        print(f"SDPA {what} at the train shape: {lib['ms']:.4f} ms "
              f"[{lib['call']}; masked {lib['masked_ms']:.4f}, flash "
              f"{lib['flash_ms']:.4f}]")
    return res


# ---------------------------------------------------------------------------
# Train phase
# ---------------------------------------------------------------------------

def train_host_batch(cfg, tok, rng, B: int = 8, n_samples: int = 160_000,
                     n_frames: int = 25, n_label: int = 48, size: int = 224):
    """8 utterances of 10 s audio, 25 frames of ``size`` px and a transcript
    of n_label tokens (n_label - 1 bytes + EOS), collated on the host."""
    from avsr_tpu_torch.data.dataset import Sample
    from avsr_tpu_torch.data.loader import collate

    t = np.arange(n_samples, dtype=np.float32) / 16000.0
    text = ("the quick brown fox jumps over a lazy dog while seven wizards "
            "brew hazy potions")[: n_label - 1]
    samples = []
    for i in range(B):
        audio = (0.3 * np.sin(2 * np.pi * rng.uniform(80, 300) * t)
                 + 0.05 * rng.standard_normal(n_samples)).astype(np.float32)
        frames = rng.integers(0, 256, (n_frames, size, size, 3), dtype=np.uint8)
        samples.append(Sample(f"train/{i}", audio, frames, text,
                              tok.encode(text, add_eos=True)))
    return collate(samples, cfg.data, tok.encode(cfg.model.prompt, add_bos=True),
                   tok.pad_id)


def _perturb_lora_b(params, gen) -> None:
    """LoRA b is 0 at init, which leaves the gradients of a exactly 0; give
    it values so that the parity checks cover a."""
    import torch

    for layer in params["llm"]["layers"]:
        for node in layer.values():
            if "lora" in node:
                b = node["lora"]["b"]
                b.copy_(0.05 * torch.randn(b.shape, generator=gen,
                                           device=b.device, dtype=b.dtype))


def _grads(params, mc, batch, dtype, use_kernel: str):
    import torch

    from avsr_tpu_torch.models.avsr import forward
    from avsr_tpu_torch.train.state import partition_trainable, tree_leaves

    leaves = tree_leaves(partition_trainable(params, mc)[0])
    for t in leaves:
        t.requires_grad_(True)
    loss, _ = forward(params, mc, batch, compute_dtype=dtype,
                      use_kernel=use_kernel, remat=True)
    # a leaf that feeds no output (CLIP's ln_post under
    # unfreeze_layer_norms) gets a zero gradient, as in JAX
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    for t in leaves:
        t.requires_grad_(False)
    return loss.item(), [torch.zeros_like(t, dtype=torch.float32) if g is None
                         else g.float() for t, g in zip(leaves, grads)]


def _dist(a: list, b: list) -> float:
    """||a - b|| / ||b|| over all leaves together."""
    import torch

    num = torch.sqrt(sum(((x - y) ** 2).sum() for x, y in zip(a, b)))
    den = torch.sqrt(sum((y ** 2).sum() for y in b))
    return (num / den).item()


def train_phase(seed: int) -> dict:
    import torch

    from avsr_tpu_torch.convert import param_count
    from avsr_tpu_torch.core.config import flagship
    from avsr_tpu_torch.data.loader import featurize
    from avsr_tpu_torch.data.tokenizer import ByteTokenizer
    from avsr_tpu_torch.models.avsr import init_avsr_model
    from avsr_tpu_torch.ops import attention as A
    from avsr_tpu_torch.ops import qmatmul as Q
    from avsr_tpu_torch.train.state import (cast_frozen, create_train_state,
                                            partition_trainable, tree_leaves)
    from avsr_tpu_torch.train.step import make_train_step, microbatch

    cfg = flagship()
    mc, accum = cfg.model, cfg.training.grad_accum_steps
    tok = ByteTokenizer()
    rng = np.random.default_rng(seed + 2)
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    t0 = time.perf_counter()
    p32 = init_avsr_model(mc, seed=seed, device="cuda", dtype=torch.float32)
    _perturb_lora_b(p32, gen)
    torch.cuda.synchronize()
    print(f"train: random init of {param_count(p32) / 1e9:.3f} B params (f32) "
          f"in {time.perf_counter() - t0:.2f} s")
    hb = train_host_batch(cfg, tok, rng)
    b32 = featurize(hb, "cuda", torch.float32)
    check(tuple(hb.labels.shape) == (8, 128) and hb.label_lens.tolist() == [48] * 8,
          "train batch labels")

    # Gradient parity in f32: the kernel path against the plain path.
    loss_k, g_k = _grads(p32, mc, b32, torch.float32, "auto")
    loss_p, g_p = _grads(p32, mc, b32, torch.float32, "never")
    per_leaf = [_dist([a], [b]) for a, b in zip(g_k, g_p)]
    check(abs(loss_k - loss_p) <= 1e-4 * abs(loss_p),
          f"f32 loss: kernel {loss_k} vs plain {loss_p}")
    check(max(per_leaf) <= 1e-3, f"f32 grads: worst leaf off by {max(per_leaf):.3e}")
    print(f"train f32 parity: loss {loss_k:.6f} vs {loss_p:.6f}; worst leaf "
          f"||dg||/||g|| {max(per_leaf):.3e} over {len(per_leaf)} trainable leaves")

    # Gradient parity in bf16: the kernel path no further from the f32
    # gradients than twice the plain path is.
    params = cast_frozen(p32, mc, torch.bfloat16)
    del p32, b32
    torch.cuda.empty_cache()
    b16 = featurize(hb, "cuda", torch.bfloat16)
    loss_kb, g_kb = _grads(params, mc, b16, torch.bfloat16, "auto")
    loss_pb, g_pb = _grads(params, mc, b16, torch.bfloat16, "never")
    d_k, d_p = _dist(g_kb, g_p), _dist(g_pb, g_p)
    check(d_k <= 2.0 * d_p, f"bf16 grads: kernel path {d_k:.4e} from f32 > 2x "
                            f"the plain path's {d_p:.4e}")
    print(f"train bf16 parity: loss kernel {loss_kb:.6f}, plain {loss_pb:.6f}; "
          f"||g - g_f32||/||g_f32|| kernel {d_k:.4e}, plain {d_p:.4e}")
    parity = dict(f32_loss_kernel=loss_k, f32_loss_plain=loss_p,
                  f32_worst_leaf=max(per_leaf), bf16_loss_kernel=loss_kb,
                  bf16_loss_plain=loss_pb, bf16_kernel_vs_f32=d_k,
                  bf16_plain_vs_f32=d_p)
    del g_k, g_p, g_kb, g_pb

    # Three optimizer steps at base.yaml settings: 4 micro-batches of 8,
    # remat, LoRA dropout, AdamW + cosine + clip.
    micro = [b16] + [featurize(train_host_batch(cfg, tok, rng), "cuda",
                               torch.bfloat16) for _ in range(accum - 1)]
    stacked = type(b16)(*[None if x[0] is None else torch.stack(x)
                          for x in zip(*micro)])
    state = create_train_state(params, cfg, total_steps=1000)
    step = make_train_step(cfg)
    train_p, frozen_p = partition_trainable(params, mc)
    frozen0 = [t.clone() for t in tree_leaves(frozen_p)]
    per_step = {"fwd": accum * (mc.whisper.n_layers + 2 * mc.llm.n_layers),
                "dq": accum * mc.llm.n_layers, "dkv": accum * mc.llm.n_layers}
    reset_counts()
    steps = []
    torch.cuda.reset_peak_memory_stats()
    for i in range(3):
        before = (A.launches, A.dq_launches, A.dkv_launches)
        train0 = [t.detach().clone() for t in tree_leaves(train_p)]
        stats: dict = {}
        t0 = time.perf_counter()
        m = step(state, stacked, seed + i, stats=stats)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = (A.launches - before[0], A.dq_launches - before[1],
               A.dkv_launches - before[2])
        check(got == (per_step["fwd"], per_step["dq"], per_step["dkv"]),
              f"step {i + 1} launches (fwd, dq, dkv) {got}, expected "
              f"{tuple(per_step.values())}")
        check(np.isfinite(m["loss"]) and m["skipped"] == 0.0,
              f"step {i + 1}: loss {m['loss']}, skipped {m['skipped']}")
        changed = any(not torch.equal(a, b) for a, b in zip(train0, tree_leaves(train_p)))
        # the warmup schedule starts at learning rate 0
        check(changed == (i > 0), f"step {i + 1}: trainable leaves changed={changed}")
        steps.append(dict(ms=dt * 1e3, loss=m["loss"], grad_norm=m["grad_norm"],
                          **{k: v * 1e3 for k, v in stats.items()}))
        print(f"train step {i + 1}: {dt * 1e3:.1f} ms, loss {m['loss']:.4f}, "
              f"gnorm {m['grad_norm']:.3f}, launches {got}")
    launches = {"fwd": A.launches, "dq": A.dq_launches, "dkv": A.dkv_launches}
    check(Q.int8_launches == Q.int4_launches == 0,
          "the train step launched a qmatmul kernel")
    peak = torch.cuda.max_memory_allocated()
    check(all(torch.equal(a, b) for a, b in zip(frozen0, tree_leaves(frozen_p))),
          "a frozen leaf changed")
    del frozen0
    n_utt = accum * 8
    last = steps[-1]
    res = dict(batch=f"{accum} x 8", audio_s=10, video_frames=25, label_tokens=48,
               packed_width=672, valid_len=581, steps=steps,
               ms_per_step=last["ms"], utts_per_s=n_utt / last["ms"] * 1e3,
               label_tokens_per_s=n_utt * 48 / last["ms"] * 1e3,
               peak_mem_gb=peak / 1e9, launches=launches,
               launches_per_step=per_step, parity=parity)

    # A short overfit run on one batch: the loss must fall.
    ocfg = flagship(["training.learning_rate=1e-3", "training.warmup_steps=1",
                     "training.grad_accum_steps=1"])
    ostate = create_train_state(params, ocfg, total_steps=100)
    ostep = make_train_step(ocfg)
    losses = [ostep(ostate, microbatch(b16, 1), 100 + i)["loss"] for i in range(5)]
    check(losses[-1] < losses[0], f"overfit losses do not fall: {losses}")
    print(f"train overfit on one batch: losses {[round(x, 4) for x in losses]}")
    res["overfit_losses"] = losses
    print("train: " + json.dumps(res))
    return res


def settle() -> None:
    """Between phases: collect the garbage of the last one (reference
    cycles can hold its tensors until a collection runs), so that the next
    phase's peak memory counts only what it keeps itself."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# CLI phase
# ---------------------------------------------------------------------------

def cli_phase(seed: int, extra: tuple[str, ...] = (), tag: str = "cli",
              out_dir: Path | None = None) -> None:
    import torch

    from avsr_tpu_torch.cli import decode
    from avsr_tpu_torch.core.config import flagship, load_config

    out_dir = out_dir or ROOT / "outputs" / "chip_smoke" / time.strftime(f"{tag}_%Y%m%d_%H%M%S")
    # the flagship config through CLI overrides (no YAML parser needed);
    # synthetic_size 40 gives an 8-utterance test split
    run = ["data.synthetic=true", "data.synthetic_size=40",
           "decode.max_new_tokens=16", f"decode.output_dir={out_dir}", *extra]
    flag = list(FLAGSHIP_OVERRIDES)
    check(load_config(None, flag + run) == flagship(run),
          "CLI overrides do not give the flagship config")
    t0 = time.perf_counter()
    rc = decode.main(["--seed", str(seed), "--device", "cuda", *flag, *run])
    torch.cuda.synchronize()
    check(rc == 0, f"decode CLI returned {rc}")
    results = list(out_dir.glob("results_*.txt"))
    wers = list(out_dir.glob("wer_*.txt"))
    check(len(results) == 1 and len(wers) == 1, f"CLI artifacts missing in {out_dir}")
    n_utt = results[0].read_text().count("UTT: ")
    check(n_utt == 8, f"results file holds {n_utt} utterances, not 8")
    check("WER: " in wers[0].read_text(), "WER summary missing")
    print(f"{tag} phase: 8 utterances decoded in {time.perf_counter() - t0:.2f} s; "
          f"wrote {results[0].relative_to(ROOT)} and {wers[0].relative_to(ROOT)}")


def train_cli_phase(seed: int) -> None:
    import shutil

    import torch

    from avsr_tpu_torch.cli import train
    from avsr_tpu_torch.core.config import flagship, load_config

    out_dir = ROOT / "outputs" / "chip_smoke" / time.strftime("train_%Y%m%d_%H%M%S")
    run = ["data.synthetic=true", "training.max_steps=2",
           "training.save_every_steps=0", f"training.checkpoint_dir={out_dir}"]
    flag = list(FLAGSHIP_OVERRIDES)
    check(load_config(None, flag + run) == flagship(run),
          "CLI overrides do not give the flagship config")
    t0 = time.perf_counter()
    try:
        rc = train.main(["--seed", str(seed), "--device", "cuda", *flag, *run])
        torch.cuda.synchronize()
    finally:                          # the final checkpoint holds ~3.5 GB
        shutil.rmtree(out_dir / "ckpt", ignore_errors=True)
    check(rc == 0, f"train CLI returned {rc}")
    rows = (out_dir / "loss_log.csv").read_text().splitlines()
    splits = [r.split(",")[2] for r in rows[1:]]
    check(splits.count("train") == 2, f"loss_log.csv rows: {splits}")
    print(f"train cli phase: 2 steps (4 x 8 synthetic utterances each) and "
          f"validation in {time.perf_counter() - t0:.2f} s; wrote "
          f"{(out_dir / 'loss_log.csv').relative_to(ROOT)}: {rows[1:]}")


# ---------------------------------------------------------------------------
# Checkpoint phase
# ---------------------------------------------------------------------------

class _Records(logging.Handler):
    """Keeps the log records of the port's loggers (the checkpoint, resume
    and WER-eval numbers are logged by the code under test)."""

    def __init__(self) -> None:
        super().__init__()
        self.records: list[logging.LogRecord] = []

    def emit(self, record: logging.LogRecord) -> None:
        self.records.append(record)

    def args(self, prefix: str) -> list[tuple]:
        return [r.args for r in self.records if str(r.msg).startswith(prefix)]


def counts() -> dict[str, int]:
    from avsr_tpu_torch.ops import attention as A
    from avsr_tpu_torch.ops import qmatmul as Q

    return dict(flash_fwd=A.launches, flash_bwd_dq=A.dq_launches,
                flash_bwd_dkv=A.dkv_launches, qmatmul_int8=Q.int8_launches,
                qmatmul_int4=Q.int4_launches)


def since(before: dict[str, int]) -> dict[str, int]:
    return {k: v - before[k] for k, v in counts().items()}


def loss_rows(run_dir: Path) -> list[list[str]]:
    return [r.split(",") for r in (run_dir / "loss_log.csv").read_text().splitlines()[1:]]


def jax_numpy_state(step_dir: Path, cfg) -> dict:
    """A port checkpoint step (AdamW) in the numpy layout that
    ``tools/orbax_to_port.py`` builds from a JAX run's Orbax step: the
    parameter tree as numpy, optax's chain for ``training.optimizer=adamw``
    with every named tuple as ``{"_type": ...}`` and every tuple as a list,
    the moments over the trainable partition with None at frozen leaves.
    The inverse of ``train/import_state.py``, for a card's host, where no
    JAX run can be restored."""
    import ml_dtypes
    import torch

    from avsr_tpu_torch.train.checkpoint import load_params
    from avsr_tpu_torch.train.state import partition_trainable, tree_map_with_path

    check(cfg.training.optimizer == "adamw", "jax_numpy_state writes AdamW's chain")
    params = load_params(step_dir)
    train = torch.load(step_dir / "train.pt", map_location="cpu", weights_only=True)
    leaves, count = train["opt_state"]["leaves"], np.int32(train["opt_state"]["count"])
    part, _ = partition_trainable(params, cfg.model)

    def moment(key: str):
        return tree_map_with_path(
            lambda p, t: None if t is None else leaves["/".join(p)][key].numpy(), part)

    return {"step": np.int32(train["step"]),
            "params": tree_map_with_path(
                lambda p, t: t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
                if t.dtype == torch.bfloat16 else t.numpy(), params),
            "opt_state": [{"_type": "EmptyState"}, [
                {"_type": "ScaleByAdamState", "count": count, "mu": moment("exp_avg"),
                 "nu": moment("exp_avg_sq")},
                {"_type": "MaskedState", "inner_state": {"_type": "EmptyState"}},
                {"_type": "ScaleByScheduleState", "count": count}]]}


def frames_phase(seed: int) -> dict:
    """``ops/image.py::preprocess_frames`` on the card against the same call
    on the CPU: 25 frames of 160 x 120 to 224, in f32 (max |d| <= 1e-5) and
    bf16 (within one bf16 rounding of the CPU's f32, |d| <= 2^-8 |x| + 1e-5),
    and its time per call (CUDA events over 20 calls)."""
    import torch

    from avsr_tpu_torch.ops.image import preprocess_frames

    gen = torch.Generator().manual_seed(seed)
    frames = torch.randint(0, 256, (25, 120, 160, 3), dtype=torch.uint8, generator=gen)
    ref = preprocess_frames(frames, 224)
    res = {"shape": [25, 120, 160, 3], "image_size": 224}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        dev = frames.cuda()
        got = preprocess_frames(dev, 224, dtype=dtype)
        torch.cuda.synchronize()
        d = (got.float().cpu() - ref).abs()
        check(got.shape == (25, 3, 224, 224) and got.dtype == dtype
              and bool(torch.isfinite(got).all()), f"preprocess_frames {name}: {got.shape}")
        tol = 1e-5 if dtype == torch.float32 else 2 ** -8 * ref.abs() + 1e-5
        check(bool((d <= tol).all()), f"preprocess_frames {name} on the card: max|d| "
              f"{d.max().item():.3e} against the CPU")
        ms = time_ms(lambda: preprocess_frames(dev, 224, dtype=dtype), iters=20)
        res[name] = {"max_abs_err": d.max().item(), "ms": ms}
    print(f"preprocess_frames ({gpu_line()}): 25 x 120 x 160 -> 224, f32 max|d| "
          f"{res['f32']['max_abs_err']:.3e} ({res['f32']['ms']:.3f} ms), bf16 max|d| "
          f"{res['bf16']['max_abs_err']:.3e} ({res['bf16']['ms']:.3f} ms) against the CPU")
    return res


def checkpoint_phase(seed: int, bf16: dict, preset: dict) -> dict:
    """train -> checkpoint -> resume -> in-training WER -> decode from the
    checkpoint (bf16 and the serving preset) -> WER, and averaging and
    preemption, through the port's CLIs at the flagship's full width with
    LoRA dropout off (a resumed run restarts its dropout seeds, as the JAX
    Trainer does, so only a run without dropout can equal an uninterrupted
    one). Then a JAX run's checkpoint continued and served: run A's step 2
    in the numpy layout of ``tools/orbax_to_port.py`` (``jax_numpy_state``)
    is imported by ``train/import_state.py`` into a fresh directory, the
    train CLI resumes it for step 3 (equal to run C's, with exact launches)
    and the decode CLI's hypotheses from it equal those from run A's
    directory. The preemption pair runs at ``MESH_DEPTH``. Every directory
    it writes (about 3.5 GB per checkpoint step) is removed at the end."""
    import gc
    import shutil

    import torch

    from avsr_tpu_torch.cli import average, common, decode, train
    from avsr_tpu_torch.core.config import flagship
    from avsr_tpu_torch.data.loader import DataLoader, featurize
    from avsr_tpu_torch.infer.generate import generate_tokens
    from avsr_tpu_torch.train.checkpoint import load_params
    from avsr_tpu_torch.train.import_state import copy_meta, import_state, write_step
    from avsr_tpu_torch.train.loop import Trainer
    from avsr_tpu_torch.train.state import path_leaves, trainable_mask

    base = ROOT / "outputs" / "chip_smoke" / time.strftime("ckpt_%Y%m%d_%H%M%S")
    ab, c, pre, avg = base / "ab", base / "c", base / "pre", base / "avg"
    imp, run_a_json = base / "imp", base / "run_a_json"
    flag = ["--seed", str(seed), "--device", "cuda", *FLAGSHIP_OVERRIDES,
            "data.synthetic=true", "model.lora.dropout=0"]
    wer_run = ["training.keep_checkpoints=2", "training.eval_wer_every_epochs=1",
               "training.eval_wer_max_utts=8", "training.best_metric=wer"]
    dec_run = ["data.synthetic_size=40", "decode.max_new_tokens=16"]
    cfg = flagship(["model.lora.dropout=0"])
    mc = cfg.model
    rec = _Records()
    logging.getLogger("avsr_tpu_torch").addHandler(rec)
    orig_iter, orig_prepare = DataLoader.__iter__, common.prepare_params_for_decode
    seen: list[list[str]] = []
    loaded: list = []

    def spy_iter(self):
        for hb, b in orig_iter(self):
            if self.shuffle:                 # the train loader
                seen.append(list(hb.utt_ids))
            yield hb, b

    def spy_prepare(params, *a, **kw):
        loaded[:] = [params, orig_prepare(params, *a, **kw)]
        return loaded[1]

    def train_run(run_dir: Path, *extra: str, counted: bool = False) -> int:
        """The train CLI; ``counted`` records each step's launches."""
        seen.clear()
        train.Trainer = CountedSteps if counted else Trainer
        try:
            rc = train.main([*flag, *wer_run, f"training.checkpoint_dir={run_dir}", *extra])
        finally:
            train.Trainer = Trainer
        gc.collect()
        torch.cuda.empty_cache()
        return rc

    step_launches: dict[str, dict] = {}

    class CountedSteps(Trainer):
        """Each optimizer step's kernel launches, by run directory and step."""
        def _step(self, micro_batches, epoch):
            before = counts()
            m = super()._step(micro_batches, epoch)
            step_launches[f"{self.ckpt.dir.parent.name}_{self.state.step}"] = since(before)
            return m

    def decode_run(out: Path, ckpt: Path, *extra: str) -> None:
        rc = decode.main([*flag, *dec_run, f"decode.output_dir={out}", *extra,
                          "--checkpoint", str(ckpt)])
        check(rc == 0, f"decode CLI --checkpoint {ckpt} returned {rc}")
        res, wer = list(out.glob("results_*.txt")), list(out.glob("wer_*.txt"))
        check(len(res) == 1 and len(wer) == 1, f"decode artifacts missing in {out}")
        check(res[0].read_text().count("UTT: ") == 8, f"{out}: not 8 utterances")
        m = re.search(r"WER: ([0-9.]+)", wer[0].read_text())
        check(m is not None and np.isfinite(float(m.group(1))), f"{out}: no WER")

    hb = serving_host_batch(cfg, seed)
    batch = featurize(hb, "cuda", torch.bfloat16)
    gen_kw = dict(max_new_tokens=cfg.decode.max_new_tokens, eos_id=-1,
                  compute_dtype=torch.bfloat16)
    res: dict = {}
    DataLoader.__iter__ = spy_iter
    common.prepare_params_for_decode = spy_prepare
    reset_counts()
    try:
        # Run A: two steps with a checkpoint each, then validation + WER
        t0 = time.perf_counter()
        check(train_run(ab, "training.max_steps=2", "training.save_every_steps=1") == 0,
              "run A failed")
        res["run_a_s"] = time.perf_counter() - t0
        ck = ab / "ckpt"
        check((ck / "1").is_dir() and (ck / "2").is_dir(), "run A: steps 1 and 2 not saved")
        meta = json.loads((ck / "meta_2.json").read_text())
        check("data_state" in meta and "fit_state" in meta, f"meta_2.json: {sorted(meta)}")
        check((ck / "best.json").exists(), "run A wrote no best.json")
        rows = loss_rows(ab)
        splits = [r[2] for r in rows]
        check(splits.count("train") == 2 and splits.count("val") == 1
              and splits.count("val_wer") == 1, f"run A loss_log rows {splits}")
        wer_a = float(next(r[5] for r in rows if r[2] == "val_wer"))
        check(np.isfinite(wer_a), f"run A val WER {wer_a}")
        res["run_a"] = dict(val_wer=wer_a, data_state=meta["data_state"],
                            fit_state=meta["fit_state"],
                            step_s=[float(r[7]) for r in rows if r[2] == "train"])
        copy_meta(ck, run_a_json)            # the JSON a JAX run A would leave

        # Run B: the same directory, one step more, resumed (the in-training
        # WER that run A checks is not evaluated again)
        resumed = len(rec.args("resumed from step"))
        check(train_run(ab, "training.max_steps=3", "training.save_every_steps=1",
                        "training.eval_wer_every_epochs=0", "training.best_metric=loss") == 0,
              "run B failed")
        got = rec.args("resumed from step")[resumed:]
        accum = cfg.training.grad_accum_steps
        check(got == [(2, 1, 2 * accum)], f"run B resume log {got}")
        seen_b = list(seen)
        # Run C: a fresh directory, three steps uninterrupted, no save before
        # the end (its step times against run A's show what a save costs); its
        # in-training WER is not read, so it is not evaluated
        check(train_run(c, "training.max_steps=3", "training.save_every_steps=0",
                        "training.eval_wer_every_epochs=0", "training.best_metric=loss",
                        counted=True) == 0, "run C failed")
        third = seen[2 * accum:3 * accum]
        check(len(seen_b) == accum and seen_b == third,
              f"run B saw batches {seen_b}, run C's third step {third}")
        pb, pc = (path_leaves(load_params(d / "ckpt" / "3")) for d in (ab, c))
        mask = path_leaves(trainable_mask(load_params(ab / "ckpt" / "3"), mc))
        worst = 0.0
        identical = True
        for k, m in mask.items():
            if m and not torch.equal(pb[k], pc[k]):
                identical = False
                d = (pb[k].float() - pc[k].float()).abs().max().item()
                worst = max(worst, d / max(pc[k].abs().max().item(), 1e-30))
        loss_b = [r[3] for r in loss_rows(ab) if r[2] == "train" and r[0] == "3"]
        loss_c = [r[3] for r in loss_rows(c) if r[2] == "train" and r[0] == "3"]
        check(len(loss_b) == len(loss_c) == 1, "step-3 loss rows")
        check(identical or worst <= 1e-5, f"run B vs run C: max|d|/max|leaf| {worst:.3e}")
        check(identical or abs(float(loss_b[0]) - float(loss_c[0]))
              <= 1e-5 * abs(float(loss_c[0])), f"step-3 loss B {loss_b} vs C {loss_c}")
        rows_c = loss_rows(c)
        res["b_vs_c"] = dict(bit_identical=identical and loss_b == loss_c,
                             worst_rel=worst, loss_b=loss_b[0], loss_c=loss_c[0],
                             trainable_leaves=sum(mask.values()))
        res["run_c"] = dict(step_s=[float(r[7]) for r in rows_c if r[2] == "train"])
        print(f"checkpoint phase: runs A (2 steps), B (resumed, 1 step), C (3 steps); "
              f"B vs C {json.dumps(res['b_vs_c'])}")

        # A JAX run's checkpoint, continued: run A's step 2 as the numpy
        # layout that tools/orbax_to_port.py hands over, imported into a
        # fresh directory with run A's JSON, resumed by the train CLI
        t0 = time.perf_counter()
        state = jax_numpy_state(ck / "2", cfg)
        t1 = time.perf_counter()
        sd = import_state(state, cfg)
        step_dir = write_step(imp / "ckpt", sd)
        copied = copy_meta(run_a_json, imp / "ckpt")
        t2 = time.perf_counter()
        gb = sum(f.stat().st_size for f in step_dir.iterdir()) / 1e9
        src = path_leaves(load_params(ck / "2"))
        got_i = path_leaves(sd["params"])
        check(got_i.keys() == src.keys()
              and all(torch.equal(got_i[k], v) for k, v in src.items()),
              "the imported params differ from run A's step 2")
        src_opt = torch.load(ck / "2" / "train.pt", map_location="cpu", weights_only=True)
        check(sd["step"] == src_opt["step"] == 2
              and sd["opt_state"]["count"] == src_opt["opt_state"]["count"]
              and all(torch.equal(v, src_opt["opt_state"]["leaves"][n][key])
                      for n, st in sd["opt_state"]["leaves"].items()
                      for key, v in st.items()),
              "the imported AdamW state differs from run A's step 2")
        del state, sd, src, got_i, src_opt
        resumed = len(rec.args("resumed from step"))
        check(train_run(imp, "training.max_steps=3", "training.save_every_steps=0",
                        "training.eval_wer_every_epochs=0", "training.best_metric=loss",
                        counted=True) == 0, "the imported run's resume failed")
        got = rec.args("resumed from step")[resumed:]
        check(got == [(2, 1, 2 * accum)], f"imported run's resume log {got}")
        check(seen == third, f"the imported run saw batches {seen}, run C's third step {third}")
        pi = path_leaves(load_params(imp / "ckpt" / "3"))
        loss_i = [r[3] for r in loss_rows(imp) if r[2] == "train"]
        differ = [k for k, m in mask.items() if m and not torch.equal(pi[k], pc[k])]
        check(not differ and loss_i == loss_c,
              f"imported run's step 3 vs run C's: losses {loss_i} / {loss_c}, "
              f"{len(differ)} trainable leaves differ ({differ[:3]})")
        L, W = mc.llm.n_layers, mc.whisper.n_layers
        want = dict(flash_fwd=accum * (W + 2 * L), flash_bwd_dq=accum * L,
                    flash_bwd_dkv=accum * L, qmatmul_int8=0, qmatmul_int4=0)
        n_imp, n_c = step_launches["imp_3"], step_launches["c_3"]
        check(n_imp == n_c == want, f"step-3 launches: imported run {n_imp}, run C "
              f"{n_c}, expected {want}")
        res["jax_import"] = dict(
            numpy_layout_s=t1 - t0, import_s=t2 - t1, gb=gb, s_per_gb=(t2 - t1) / gb,
            leaves=len(pi), json_copied=copied, step3_loss=loss_i[0],
            step3_equals_run_c=True, step3_launches=n_imp)
        print(f"checkpoint import ({gpu_line()}): run A's step 2 ({len(pi)} leaves, "
              f"{gb:.3f} GB) imported in {t2 - t1:.2f} s ({(t2 - t1) / gb:.2f} s/GB; "
              f"numpy layout {t1 - t0:.2f} s); resumed step 3 equals run C's (loss "
              f"{loss_i[0]}), launches {n_imp}")
        del pb, pc, pi
        shutil.rmtree(c)

        # Decode from the checkpoint, bf16: the leaves the CLI loaded, then
        # one generate_tokens call at phase 3's geometry
        decode_run(base / "dec_bf16", ck)
        b3 = path_leaves(load_params(ck / "3"))
        got_p = path_leaves(loaded[0])
        keys = [k for k in b3 if "lora" in k.split("/") or k.split("/")[0].endswith("connector")]
        check(keys and all(torch.equal(got_p[k], b3[k].to(got_p[k].device, torch.bfloat16))
                           for k in keys),
              "the decode CLI's connector/LoRA leaves differ from run B's step 3")
        del b3, got_p
        params = loaded[1]
        loaded.clear()
        generate_tokens(params, mc, batch, **{**gen_kw, "max_new_tokens": 4})
        before = counts()
        st: dict = {}
        out = generate_tokens(params, mc, batch, stats=st, **gen_kw)
        n = since(before)
        want = {k: 0 for k in n}
        want["flash_fwd"] = mc.whisper.n_layers + mc.llm.n_layers
        check(n == want, f"bf16 from checkpoint: launches {n}, expected {want}")
        check(bool(torch.isfinite(st["prefill_logits"]).all()), "logits not finite")
        res["decode_bf16"] = _serving(st, out, hb, n, bf16)
        del params, out
        loaded.clear()
        gc.collect()
        torch.cuda.empty_cache()

        # The imported run serves: the decode CLI's hypotheses from its
        # directory equal those from run A's (both at step 3)
        decode_run(base / "dec_import", imp / "ckpt")
        loaded.clear()
        hyps = hyp_lines(base / "dec_import")
        check(len(hyps) == 8 and hyps == hyp_lines(base / "dec_bf16"),
              "the decode CLI's hypotheses from the imported run differ from run A's")
        res["jax_import"]["decode_hyps_equal"] = len(hyps)
        shutil.rmtree(imp)
        gc.collect()
        torch.cuda.empty_cache()

        # The same checkpoint with the serving preset: quantized after restore
        decode_run(base / "dec_preset", ck, *PRESET_OVERRIDES)
        params = loaded[1]
        loaded.clear()
        pcfg = flagship(list(PRESET_OVERRIDES))
        kw = dict(gen_kw, kv_cache_dtype=pcfg.decode.kv_cache_dtype)
        generate_tokens(params, pcfg.model, batch, **{**kw, "max_new_tokens": 4})
        before = counts()
        st = {}
        out = generate_tokens(params, pcfg.model, batch, stats=st, **kw)
        n = since(before)
        steps = st["decode_steps"]
        want = dict(flash_fwd=mc.whisper.n_layers + mc.llm.n_layers, flash_bwd_dq=0,
                    flash_bwd_dkv=0, qmatmul_int8=steps + 1,
                    qmatmul_int4=4 * mc.llm.n_layers * steps)
        check(n == want, f"preset from checkpoint: launches {n}, expected {want}")
        check(bool(torch.isfinite(st["prefill_logits"]).all()), "logits not finite")
        res["decode_preset"] = _serving(st, out, hb, n, preset)
        del params, out
        gc.collect()
        torch.cuda.empty_cache()

        # Average the newest two steps into an export, and decode it
        check(average.main([*flag, "--checkpoint", str(ck), "--last", "2",
                            "--out", str(avg)]) == 0, "average CLI failed")
        pa, p2, p3 = (path_leaves(load_params(d)) for d in (avg, ck / "2", ck / "3"))
        check(pa.keys() == p2.keys(), "averaged export's key paths")
        for k, v in pa.items():
            a, b = p2[k].cuda(), p3[k].cuda()
            want_k = ((a.float() + b.float()) / 2).to(a.dtype)
            check(v.dtype == a.dtype and torch.equal(v.cuda(), want_k),
                  f"averaged leaf {k} is not the f32 mean of steps 2 and 3")
        del pa, p2, p3
        decode_run(base / "dec_avg", avg)
        loaded.clear()
        shutil.rmtree(avg)
        gc.collect()
        torch.cuda.empty_cache()

        # Preemption: SIGTERM after step 1; the run saves at the end of step
        # 2 and stops, and the next run resumes from that checkpoint
        class PreemptedAfterStep1(Trainer):
            def _step(self, micro_batches, epoch):
                m = super()._step(micro_batches, epoch)
                if self.state.step == 1:
                    os.kill(os.getpid(), signal.SIGTERM)
                return m

        handler = signal.getsignal(signal.SIGTERM)
        train.Trainer = PreemptedAfterStep1
        try:
            check(train.main([*flag, *MESH_DEPTH, "training.max_steps=3",
                              "training.save_every_steps=0",
                              f"training.checkpoint_dir={pre}"]) == 0, "preempted run failed")
        finally:
            train.Trainer = Trainer
        gc.collect()
        torch.cuda.empty_cache()
        meta = json.loads((pre / "ckpt" / "meta_2.json").read_text())
        check(meta["tag"] == "preempt" and (pre / "ckpt" / "2").is_dir(),
              f"no preempt checkpoint: {meta['tag']}")
        check(signal.getsignal(signal.SIGTERM) is handler,
              "the Trainer left its SIGTERM handler installed")
        resumed = len(rec.args("resumed from step"))
        check(train.main([*flag, *MESH_DEPTH, "training.max_steps=3",
                          "training.save_every_steps=0",
                          f"training.checkpoint_dir={pre}"]) == 0, "resumed run failed")
        check([a[0] for a in rec.args("resumed from step")[resumed:]] == [2],
              "the run after the preemption did not resume from step 2")
        steps_pre = [int(r[0]) for r in loss_rows(pre) if r[2] == "train"]
        check(steps_pre == [1, 2, 3], f"preempted and resumed steps {steps_pre}")
        res["preempt"] = dict(steps=steps_pre, data_state=meta["data_state"])
    finally:
        DataLoader.__iter__ = orig_iter
        common.prepare_params_for_decode = orig_prepare
        logging.getLogger("avsr_tpu_torch").removeHandler(rec)
        shutil.rmtree(base, ignore_errors=True)
    check(not base.exists(), f"{base} not removed")
    res["launches"] = counts()
    saves = rec.args("checkpoint step")
    res["saves"] = [dict(step=a[0], gb=a[1], host_copy_s=a[2], write_s=a[3])
                    for a in saves]
    res["restores_s"] = [a[2] for a in rec.args("restored step")]
    res["wer_eval_s"] = [a[4] for a in rec.args("epoch %d | val WER")]
    print(f"checkpoint phase: {saves[0][1]:.3f} GB per step; saves (host copy, write s) "
          f"{[(round(a[2], 3), round(a[3], 3)) for a in saves]}; restores "
          f"{[round(x, 3) for x in res['restores_s']]} s; WER evals (8 utts) "
          f"{[round(x, 3) for x in res['wer_eval_s']]} s")
    print("checkpoint: " + json.dumps(res))
    return res


# ---------------------------------------------------------------------------
# Train-knobs phase
# ---------------------------------------------------------------------------

def bwd_shape_rows(seed: int, B: int, H: int, T: int, n: int) -> dict:
    """dQ and dK/dV at one more shape, non-causal [B, H, T, 64] with H
    kv heads and n valid rows of T (bf16): held against their plain
    versions (max|d| <= 2e-2 max|ref|), then the kernels and the SDPA
    backward of q, k and v timed from replayed CUDA graphs, the plain
    versions eagerly, beside each kernel's bound."""
    import torch

    from avsr_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn((B, H, T, 64), generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(4))
    lens = torch.full((B,), n, dtype=torch.int32, device="cuda")
    o, lse = A.flash_attention(q, k, v, lens, lens, False)
    args_dq = (q, k, v, o, lse, do, lens, lens, False)
    dq, delta = A.flash_bwd_dq(*args_dq)
    args_dkv = (q, k, v, lse, delta, do, lens, lens, False)
    dk, dv = A.flash_bwd_dkv(*args_dkv)
    refs = A.flash_attention_bwd_reference(q, k, v, o, lse, do, lens, lens, False)
    errs = {}
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
        check(bool(torch.isfinite(got.float()).all()), f"bwd [{B},{H},{T}]: {name} not finite")
        errs[name] = rel_err(got, ref)
        check(errs[name] <= 2e-2, f"bwd [{B},{H},{T}]: {name} max|d| {errs[name]:.3e} "
                                  f"x max|ref| > 2e-2")
    times = {"dq": graph_ms([lambda: A.flash_bwd_dq(*args_dq)]),
             "dkv": graph_ms([lambda: A.flash_bwd_dkv(*args_dkv)])}
    plain = {"dq": time_ms(lambda: A.flash_bwd_dq_reference(*args_dq), 3),
             "dkv": time_ms(lambda: A.flash_bwd_dkv_reference(*args_dkv), 3)}
    library = sdpa_ms(q, k, v, lens, False, do)
    bounds = attn_bounds(q, k, lens, lens, False)
    res = {"shape": dict(q=list(q.shape), kv=list(k.shape), causal=False, lens=n,
                         dtype="bfloat16"),
           "max_rel_err": errs, "library_bwd_pair": library}
    for name in ("dq", "dkv"):
        ops_ms, bytes_ms = bounds[name]
        res[name] = dict(ms=times[name], plain_ms=plain[name],
                         bound_ms=max(ops_ms, bytes_ms), ops_ms=ops_ms, bytes_ms=bytes_ms,
                         bound_by="operations" if ops_ms >= bytes_ms else "bytes")
        print(f"kernel {name} at [{B},{H},{T},64] non-causal, {n} rows: {times[name]:.4f} ms "
              f"(plain {plain[name]:.4f}, bound {res[name]['bound_ms']:.4f} by "
              f"{res[name]['bound_by']})")
    print(f"SDPA backward of q, k, v at [{B},{H},{T},64]: {library['ms']:.4f} ms "
          f"[{library['call']}; masked {library['masked_ms']:.4f}, flash "
          f"{library['flash_ms']:.4f}]; max|d|/max|ref| {errs}")
    return res


def _stack(micro: list):
    """Micro-batches [B, ...] -> one batch [accum, B, ...]."""
    import torch

    return type(micro[0])(*[None if x[0] is None else torch.stack(x)
                            for x in zip(*micro)])


def _tree_bytes(tree) -> int:
    from avsr_tpu_torch.train.state import path_leaves

    return sum(t.numel() * t.element_size() for t in path_leaves(tree).values())


def _run_steps(cfg, params, batch, n: int, tag: str, seed: int, expect=None) -> tuple:
    """``n`` optimizer steps of ``make_train_step(cfg)`` on ``batch`` from a
    fresh train state over ``params`` (updated in place): per step its ms,
    forward / backward / optimizer ms, loss and launches, and the peak
    device memory of the steps (counted from a reset just before them)."""
    import torch

    from avsr_tpu_torch.train.state import create_train_state
    from avsr_tpu_torch.train.step import make_train_step

    state = create_train_state(params, cfg, total_steps=1000)
    step = make_train_step(cfg)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for i in range(n):
        before = counts()
        stats: dict = {}
        t0 = time.perf_counter()
        m = step(state, batch, seed + i, stats=stats)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = since(before)
        check(np.isfinite(m["loss"]) and m["skipped"] == 0.0,
              f"{tag} step {i + 1}: loss {m['loss']}, skipped {m['skipped']}")
        if expect is not None:
            check(got == expect, f"{tag} step {i + 1} launches {got}, expected {expect}")
        steps.append(dict(ms=dt * 1e3, loss=m["loss"], grad_norm=m["grad_norm"],
                          launches=got, **{k: m[k] for k in ("moe_lb", "moe_z") if k in m},
                          **{k[:-2] + "_ms": v * 1e3 for k, v in stats.items()}))
        print(f"{tag} step {i + 1}: {dt * 1e3:.1f} ms ("
              + ", ".join(f"{k[:-2]} {v * 1e3:.1f}" for k, v in stats.items())
              + f"), loss {m['loss']:.4f}, gnorm {m['grad_norm']:.3f}")
    peak = torch.cuda.max_memory_allocated()
    res = dict(steps=steps, ms_per_step=steps[-1]["ms"], peak_mem_gb=peak / 1e9,
               resident_before_gb=resident / 1e9)
    return state, res


def train_knobs_phase(seed: int, train: dict) -> dict:
    """The training knobs at the flagship's full width (random weights from
    --seed, base.yaml settings, 4 x 8 utterances of 10 s and 25 frames):

    a. QLoRA, ``--mode 4bit``: f32 gradients of the kernel path against
       the plain path; three optimizer steps with their split, peak memory
       (below the bf16 train phase's) and launches; the dequantize calls
       of a step and their device time; then the train CLI with ``--mode
       4bit``: run A (2 steps, a checkpoint each, validation, in-training
       WER), run B (resumed, step 3), run C (3 steps uninterrupted), B's
       third step equal to C's bit for bit.
    b. The decode CLI from run B's checkpoint with the serving preset: the
       quantized and LoRA leaves it loaded equal the checkpoint's, and one
       generate_tokens call has exact launch counts.
    c. One optimizer step (after one more) each of ``--mode 8bit``,
       ``--mode max`` and bf16 (``standard``, the 4bit step's yardstick):
       ms and peak memory.
    d. ``model.unfreeze_layer_norms``: f32 gradients (the encoder layer
       norms included) of the kernel path against the plain path, and
       steps with the Whisper encoder's backward launches; then dQ and
       dK/dV at the Whisper shape, timed.
    e. The batch-size probe at the worst-case bucket (30 s, 100 frames,
       128 labels), bf16 and ``--mode 4bit``, up to 16.
    f. SpecAugment and video augmentation: padding bit-identical, the eval
       step unchanged by the knobs, one train step.
    g. Two steps each of adafactor and lion, their state bytes against
       AdamW's.

    The parts run in the order c, a, b, f, g, d, e, so that each step's
    peak memory counts only its own weights and batches. Every launch count
    is reset at the start; the counts of each part and of the whole phase
    are returned. Directories written are removed."""
    import gc
    import shutil

    import torch

    from avsr_tpu_torch.cli import common, decode
    from avsr_tpu_torch.cli import train as train_cli
    from avsr_tpu_torch.core.config import flagship, load_config
    from avsr_tpu_torch.data.loader import featurize
    from avsr_tpu_torch.data.tokenizer import ByteTokenizer
    from avsr_tpu_torch.infer.generate import generate_tokens
    from avsr_tpu_torch.models.avsr import init_avsr_model
    from avsr_tpu_torch.ops import quant
    from avsr_tpu_torch.train import probe
    from avsr_tpu_torch.train.checkpoint import load_params
    from avsr_tpu_torch.train.state import (cast_frozen, path_leaves,
                                            trainable_mask)
    from avsr_tpu_torch.train.step import augment, make_eval_step, microbatch

    def mode_cfg(mode: str, *extra: str):
        """``--config base.yaml --mode MODE extra...``: the flagship's
        settings take the YAML file's place, under the preset."""
        return load_config(None, [*FLAGSHIP_OVERRIDES, *common.MODE_OVERRIDES[mode],
                                  *extra])

    def free() -> None:
        gc.collect()
        torch.cuda.empty_cache()

    res: dict = {}
    by_path: dict = {}
    reset_counts()
    tok = ByteTokenizer()
    rng = np.random.default_rng(seed + 5)
    gen = torch.Generator(device="cuda").manual_seed(seed + 5)
    cfg4 = mode_cfg("4bit")
    mc, accum = cfg4.model, cfg4.training.grad_accum_steps
    L = mc.llm.n_layers
    hbs = [train_host_batch(cfg4, tok, rng) for _ in range(accum)]

    micro = [featurize(hb, "cuda", torch.bfloat16) for hb in hbs]
    stacked = _stack(micro)

    # c. --mode 8bit and --mode max, one step each after a first one, and
    # the bf16 step ("standard") with this phase's resident set, the 4bit
    # step's yardstick (phase 6's peak also holds its frozen-leaf copy)
    before = counts()
    for mode in ("standard", "8bit", "max"):
        mcfg = mode_cfg(mode)
        mp = common.init_params(mcfg, seed=seed, device="cuda")
        free()
        macc = mcfg.training.grad_accum_steps
        mbatch = stacked if macc == accum else microbatch(micro[0], macc)
        st_m, r = _run_steps(mcfg, mp, mbatch, 2, f"--mode {mode}", seed)
        r.update(grad_accum_steps=macc, micro_batch=int(mbatch.labels.shape[1]))
        res[f"mode_{mode}"] = r
        del st_m, mp
        free()
    check(res["mode_max"]["grad_accum_steps"] == 8 and res["mode_max"]["micro_batch"] == 1,
          "--mode max did not give 8 micro-batches of 1")
    by_path["modes"] = since(before)

    # a. QLoRA: f32 gradient parity, then bf16 steps
    before = counts()
    p32 = init_avsr_model(mc, seed=seed, device="cuda", dtype=torch.float32)
    _perturb_lora_b(p32, gen)
    p32["llm"] = quant.quantize_llm(p32["llm"], 4)
    free()
    b32 = featurize(hbs[0], "cuda", torch.float32)
    loss_k, g_k = _grads(p32, mc, b32, torch.float32, "auto")
    loss_p, g_p = _grads(p32, mc, b32, torch.float32, "never")
    per_leaf = [_dist([a], [b]) for a, b in zip(g_k, g_p)]
    check(abs(loss_k - loss_p) <= 1e-4 * abs(loss_p),
          f"4bit f32 loss: kernel {loss_k} vs plain {loss_p}")
    check(max(per_leaf) <= 1e-3, f"4bit f32 grads: worst leaf off by {max(per_leaf):.3e}")
    print(f"4bit f32 parity: loss {loss_k:.6f} vs {loss_p:.6f}; worst leaf "
          f"||dg||/||g|| {max(per_leaf):.3e} over {len(per_leaf)} trainable leaves")
    res["qlora_f32_parity"] = dict(loss_kernel=loss_k, loss_plain=loss_p,
                                   worst_leaf=max(per_leaf), leaves=len(per_leaf))
    params = cast_frozen(p32, mc, torch.bfloat16)
    del p32, b32, g_k, g_p
    free()
    calls = [0]
    orig_dequantize = quant.dequantize

    def counting(qp, dtype=torch.float32):
        calls[0] += 1
        return orig_dequantize(qp, dtype)

    per_step = dict(flash_fwd=accum * (mc.whisper.n_layers + 2 * L), flash_bwd_dq=accum * L,
                    flash_bwd_dkv=accum * L, qmatmul_int8=0, qmatmul_int4=0)
    quant.dequantize = counting
    try:
        state, q4 = _run_steps(cfg4, params, stacked, 3, "4bit", seed, per_step)
    finally:
        quant.dequantize = orig_dequantize
    n_proj = sum(quant.is_quantized(nd) for layer in params["llm"]["layers"]
                 for nd in layer.values())
    per_step_calls = calls[0] / 3
    check(per_step_calls == 3 * accum * n_proj,
          f"a 4bit step dequantized {per_step_calls} times, expected 3 x {accum} x "
          f"{n_proj} (forward, remat's recompute, backward)")
    adamw_bytes = _tree_bytes(state.optimizer.state_dict()["leaves"])
    del state
    free()
    check(q4["peak_mem_gb"] < train["peak_mem_gb"],
          f"4bit step peak {q4['peak_mem_gb']:.3f} GB not below the bf16 train "
          f"phase's {train['peak_mem_gb']:.3f} GB")
    check(q4["peak_mem_gb"] < res["mode_standard"]["peak_mem_gb"],
          f"4bit step peak {q4['peak_mem_gb']:.3f} GB not below the bf16 step's "
          f"{res['mode_standard']['peak_mem_gb']:.3f} GB in this phase")
    nodes = [nd for layer in params["llm"]["layers"] for nd in layer.values()
             if quant.is_quantized(nd)]

    def dequantize_llm():
        for nd in nodes:
            quant.dequantize(nd, torch.bfloat16)

    full_ms = graph_ms([dequantize_llm], reps=5)
    q4.update(dequantize_calls_per_step=per_step_calls, full_llm_dequantize_ms=full_ms,
              dequantize_ms_per_step=full_ms * per_step_calls / n_proj,
              llm_bytes=quant.quant_bytes(params["llm"]["layers"]),
              adamw_state_bytes=adamw_bytes, bf16_peak_mem_gb=train["peak_mem_gb"])
    print(f"4bit: peak {q4['peak_mem_gb']:.3f} GB (bf16 train phase "
          f"{train['peak_mem_gb']:.3f}); {per_step_calls:.0f} dequantizes per step = "
          f"{per_step_calls / n_proj:.0f} full-LLM dequantizes of {full_ms:.3f} ms = "
          f"{q4['dequantize_ms_per_step']:.2f} ms per step")
    res["qlora_4bit"] = q4
    by_path["qlora_steps"] = since(before)

    # a (cont.) and b: the train CLI with --mode 4bit, resume, decode
    base = ROOT / "outputs" / "chip_smoke" / time.strftime("knobs_%Y%m%d_%H%M%S")
    ab, c = base / "ab", base / "c"
    common_args = ["--seed", str(seed), "--device", "cuda", *FLAGSHIP_OVERRIDES,
                   "data.synthetic=true", "model.lora.dropout=0"]
    wer_run = ["training.keep_checkpoints=2", "training.eval_wer_every_epochs=1",
               "training.eval_wer_max_utts=8"]
    rec = _Records()
    logging.getLogger("avsr_tpu_torch").addHandler(rec)
    orig_prepare = common.prepare_params_for_decode
    loaded: list = []

    def spy_prepare(p, *a, **kw):
        loaded[:] = [p, orig_prepare(p, *a, **kw)]
        return loaded[1]

    def train_run(run_dir: Path, *extra: str) -> None:
        rc = train_cli.main(["--mode", "4bit", *common_args, *wer_run,
                             f"training.checkpoint_dir={run_dir}", *extra])
        check(rc == 0, f"train CLI --mode 4bit ({run_dir.name} {extra}) returned {rc}")
        free()

    common.prepare_params_for_decode = spy_prepare
    try:
        before = counts()
        t0 = time.perf_counter()
        train_run(ab, "training.max_steps=2", "training.save_every_steps=1")
        res_cli = dict(run_a_s=time.perf_counter() - t0)
        ck = ab / "ckpt"
        check((ck / "1").is_dir() and (ck / "2").is_dir(), "4bit run A: steps not saved")
        rows = loss_rows(ab)
        splits = [r[2] for r in rows]
        check(splits.count("train") == 2 and splits.count("val") == 1
              and splits.count("val_wer") == 1, f"4bit run A loss_log rows {splits}")
        wer_a = float(next(r[5] for r in rows if r[2] == "val_wer"))
        check(np.isfinite(wer_a), f"4bit run A val WER {wer_a}")
        # runs B and C leave out the in-training WER eval that run A checks
        resumed = len(rec.args("resumed from step"))
        train_run(ab, "training.max_steps=3", "training.save_every_steps=1",
                  "training.eval_wer_every_epochs=0")
        got = rec.args("resumed from step")[resumed:]
        check(got == [(2, 1, 2 * accum)], f"4bit run B resume log {got}")
        train_run(c, "training.max_steps=3", "training.save_every_steps=0",
                  "training.eval_wer_every_epochs=0")
        pb, pc = (path_leaves(load_params(d / "ckpt" / "3")) for d in (ab, c))
        mask = path_leaves(trainable_mask(load_params(ab / "ckpt" / "3"), mc))
        differ = [k for k, m in mask.items() if m and not torch.equal(pb[k], pc[k])]
        loss_b = [r[3] for r in loss_rows(ab) if r[2] == "train" and r[0] == "3"]
        loss_c = [r[3] for r in loss_rows(c) if r[2] == "train" and r[0] == "3"]
        check(not differ and len(loss_b) == 1 and loss_b == loss_c,
              f"4bit run B vs C: step-3 losses {loss_b} / {loss_c}, "
              f"{len(differ)} trainable leaves differ ({differ[:3]})")
        q_leaves = [k for k in pb if k.endswith("qw4h")]
        check(len(q_leaves) == 7 * L and all(pb[k].dtype == torch.int8 for k in q_leaves),
              f"the 4bit checkpoint holds {len(q_leaves)} int4 leaves")
        saves = rec.args("checkpoint step")
        res_cli.update(
            b_equals_c=dict(loss=loss_b[0], trainable_leaves=sum(mask.values())),
            step_s_run_c=[float(r[7]) for r in loss_rows(c) if r[2] == "train"],
            val_wer_run_a=wer_a,
            saves=[dict(step=a[0], gb=a[1], host_copy_s=a[2], write_s=a[3]) for a in saves],
            wer_eval_s=[a[4] for a in rec.args("epoch %d | val WER")])
        print(f"4bit train CLI: runs A, B (resumed), C; B's step 3 equals C's "
              f"(loss {loss_b[0]}); checkpoint {saves[0][1]:.3f} GB, writes "
              f"{[round(a[3], 3) for a in saves]} s; step s (run C) "
              f"{res_cli['step_s_run_c']}")
        del pc
        shutil.rmtree(c)
        by_path["qlora_train_cli"] = since(before)

        # b. the decode CLI from run B's checkpoint with the serving preset
        before = counts()
        out = base / "dec"
        rc = decode.main([*common_args, "data.synthetic_size=40", "decode.max_new_tokens=16",
                          *PRESET_OVERRIDES, f"decode.output_dir={out}",
                          "--checkpoint", str(ck)])
        check(rc == 0, f"decode CLI from the 4bit checkpoint returned {rc}")
        check(len(list(out.glob("results_*.txt"))) == 1, "decode artifacts missing")
        got_p = path_leaves(loaded[0])
        lora = [k for k in pb if "lora" in k.split("/")]
        check(lora and all(torch.equal(got_p[k], pb[k].to(got_p[k].device, torch.bfloat16))
                           for k in lora),
              "the decode CLI's LoRA leaves differ from the checkpoint's")
        check(all(torch.equal(got_p[k], pb[k].to(got_p[k].device)) for k in q_leaves),
              "the decode CLI's int4 leaves differ from the checkpoint's")
        dparams = loaded[1]
        loaded.clear()
        del pb, got_p
        pcfg = flagship(list(PRESET_OVERRIDES))
        hb = serving_host_batch(pcfg, seed)
        batch = featurize(hb, "cuda", torch.bfloat16)
        kw = dict(max_new_tokens=pcfg.decode.max_new_tokens, eos_id=-1,
                  compute_dtype=torch.bfloat16, kv_cache_dtype=pcfg.decode.kv_cache_dtype)
        generate_tokens(dparams, pcfg.model, batch, **{**kw, "max_new_tokens": 4})
        one = counts()
        st: dict = {}
        gout = generate_tokens(dparams, pcfg.model, batch, stats=st, **kw)
        n = since(one)
        steps = st["decode_steps"]
        want = dict(flash_fwd=mc.whisper.n_layers + L, flash_bwd_dq=0, flash_bwd_dkv=0,
                    qmatmul_int8=steps + 1, qmatmul_int4=4 * L * steps)
        check(n == want, f"decode from the 4bit checkpoint: launches {n}, expected {want}")
        check(bool(torch.isfinite(st["prefill_logits"]).all()) and
              tuple(gout.tokens.shape) == (8, pcfg.decode.max_new_tokens),
              "decode from the 4bit checkpoint: logits or tokens")
        res_cli["decode"] = dict(launches=n, decode_steps=steps,
                                 ms_per_token=st["decode_s"] * 1e3 / steps,
                                 prefill_ms=st["prefill_s"] * 1e3)
        print(f"decode from the 4bit checkpoint (preset): launches {n}")
        del dparams, gout, batch
        free()
        by_path["qlora_decode"] = since(before)
    finally:
        common.prepare_params_for_decode = orig_prepare
        logging.getLogger("avsr_tpu_torch").removeHandler(rec)
        shutil.rmtree(base, ignore_errors=True)
    check(not base.exists(), f"{base} not removed")
    res["qlora_cli"] = res_cli

    # f. SpecAugment and video augmentation (on the QLoRA params)
    before = counts()
    acfg = mode_cfg("4bit", "data.specaugment=true", "data.video_augment=true")
    lens = micro[0].mel_lens.clone()
    flens = micro[0].frame_lens.clone()
    lens[::2] = lens[::2] * 7 // 10          # rows with padding frames
    flens[::2] = flens[::2] - 7
    padded = micro[0]._replace(mel_lens=lens, frame_lens=flens)
    aug, _ = augment(acfg, padded, seed)
    for i in range(0, 8, 2):
        n_mel, n_vid = int(lens[i]), int(flens[i])
        check(torch.equal(aug.mel[i, :, n_mel:], padded.mel[i, :, n_mel:])
              and torch.equal(aug.frames[i, n_vid:], padded.frames[i, n_vid:]),
              f"augmentation touched padding of row {i}")
        check(not torch.equal(aug.mel[i, :, :n_mel], padded.mel[i, :, :n_mel])
              and not torch.equal(aug.frames[i, :n_vid], padded.frames[i, :n_vid]),
              f"augmentation left row {i} unchanged")
    ev = [make_eval_step(c_)(params, padded) for c_ in (acfg, cfg4)]
    check(ev[0] == ev[1], f"the eval step changed with the augmentation knobs: {ev}")
    st_a, ra = _run_steps(acfg, params, microbatch(padded, 1), 1, "augment", seed)
    ra["eval"] = ev[0]
    res["augment"] = ra
    del st_a
    free()

    # g. adafactor and lion (on the QLoRA params)
    opts = {"adamw": dict(state_bytes=adamw_bytes)}
    tmask4 = path_leaves(trainable_mask(params, mc))

    def trainable_now() -> list:
        return [v.detach().clone() for k, v in path_leaves(params).items() if tmask4[k]]

    for name in ("adafactor", "lion"):
        ocfg = mode_cfg("4bit", f"training.optimizer={name}")
        leaves0 = trainable_now()
        st_o, ro = _run_steps(ocfg, params, stacked, 2, name, seed)
        ro["state_bytes"] = _tree_bytes(st_o.optimizer.state_dict()["leaves"])
        after = trainable_now()
        check(any(not torch.equal(a, b) for a, b in zip(leaves0, after)),
              f"{name}: no trainable leaf changed in two steps")
        print(f"{name}: optimizer state {ro['state_bytes'] / 1e6:.2f} MB "
              f"(AdamW {adamw_bytes / 1e6:.2f} MB)")
        opts[name] = ro
        del st_o, leaves0, after
        free()
    res["optimizers"] = opts
    by_path["augment_and_optimizers"] = since(before)
    del params
    free()

    # d. unfreeze_layer_norms
    before = counts()
    lcfg = mode_cfg("standard", "model.unfreeze_layer_norms=true")
    lmc = lcfg.model
    p32 = init_avsr_model(lmc, seed=seed, device="cuda", dtype=torch.float32)
    _perturb_lora_b(p32, gen)
    b32 = featurize(hbs[0], "cuda", torch.float32)
    tmask = path_leaves(trainable_mask(p32, lmc))
    train_names = [k for k, m in tmask.items() if m]
    loss_k, g_k = _grads(p32, lmc, b32, torch.float32, "auto")
    loss_p, g_p = _grads(p32, lmc, b32, torch.float32, "never")
    ln_worst, all_worst, live = 0.0, 0.0, 0
    for k, a, b in zip(train_names, g_k, g_p):
        if not b.abs().max():              # CLIP's ln_post feeds no output
            check(not a.abs().max(), f"unfreeze_layer_norms: {k} has a gradient")
            continue
        d = _dist([a], [b])
        all_worst = max(all_worst, d)
        if k.split("/")[0] in ("whisper", "clip"):
            ln_worst, live = max(ln_worst, d), live + 1
    check(live >= 4 * mc.whisper.n_layers and all_worst <= 1e-3
          and abs(loss_k - loss_p) <= 1e-4 * abs(loss_p),
          f"unfreeze_layer_norms f32: {live} live encoder LN leaves, worst leaf "
          f"{all_worst:.3e}, loss {loss_k} vs {loss_p}")
    print(f"unfreeze_layer_norms f32 parity: loss {loss_k:.6f} vs {loss_p:.6f}; "
          f"worst LN leaf {ln_worst:.3e} over {live} encoder LN leaves, worst leaf "
          f"{all_worst:.3e}")
    lparams = cast_frozen(p32, lmc, torch.bfloat16)
    del p32, b32, g_k, g_p
    free()
    W = mc.whisper.n_layers
    lstep = dict(flash_fwd=accum * (2 * W + 2 * L), flash_bwd_dq=accum * (W + L),
                 flash_bwd_dkv=accum * (W + L), qmatmul_int8=0, qmatmul_int4=0)
    st_l, lr_ = _run_steps(lcfg, lparams, stacked, 2, "unfreeze_layer_norms", seed, lstep)
    lr_.update(f32_loss_kernel=loss_k, f32_loss_plain=loss_p, f32_worst_ln_leaf=ln_worst,
               f32_worst_leaf=all_worst, live_ln_leaves=live, launches_per_step=lstep)
    res["unfreeze_layer_norms"] = lr_
    del st_l, lparams
    free()
    by_path["unfreeze_layer_norms"] = since(before)
    # the Whisper encoder's attention: 10 s of audio, 500 of 512 rows
    res["whisper_bwd"] = bwd_shape_rows(seed + 6, 8, mc.whisper.n_heads, 512, 500)
    free()

    # e. the batch-size probe at the worst-case bucket
    before = counts()
    probes = {}
    for mode in ("standard", "4bit"):
        pcfg_ = mode_cfg(mode)
        pp = common.init_params(pcfg_, seed=seed, device="cuda")
        t0 = time.perf_counter()
        # up to 16, which keeps the script within its time limit: the probe's
        # doubling and its steps at the worst-case bucket, not the card's
        # capacity
        best = probe.find_optimal_batch_size(pcfg_, pp, max_batch=16, device="cuda")
        dt = time.perf_counter() - t0
        del pp
        free()
        check(best >= 1, f"probe ({mode}): not even one utterance fits")
        probes["bf16" if mode == "standard" else mode] = dict(
            best=best, seconds=dt, mel_frames=pcfg_.data.audio_buckets[-1],
            video_frames=pcfg_.data.video_buckets[-1],
            labels=pcfg_.data.max_label_length)
        print(f"probe ({mode}): largest batch {best} at the worst-case bucket "
              f"({pcfg_.data.audio_buckets[-1]} mel frames, "
              f"{pcfg_.data.video_buckets[-1]} frames, {pcfg_.data.max_label_length} "
              f"labels) in {dt:.1f} s")
    res["probe"] = probes
    by_path["probe"] = since(before)
    del micro, stacked
    free()
    res["launches_by_path"] = by_path
    # the parts' sums: the launches that timed dQ and dK/dV at the Whisper
    # shape are not the path's
    res["launches"] = {k: sum(part[k] for part in by_path.values()) for k in counts()}
    print("train knobs: " + json.dumps(res))
    return res


# ---------------------------------------------------------------------------
# Decode-variants phase
# ---------------------------------------------------------------------------

def beam_oracle(params, mc, batch, W: int, N: int, dtype):
    """Beam search over a flat cache, the JAX package's test oracle: the
    prefix cache repeated W-fold, ``llama_decode_step`` on [B*W] rows, the
    whole cache gathered by beam every step, candidates ranked by a stable
    descending sort. Returns (best tokens [B, N], scores [B, W]); eos_id
    -1 (no beam finishes)."""
    import torch

    from avsr_tpu_torch.models import llama as L
    from avsr_tpu_torch.models.avsr import build_prefix, encode

    lora = mc.lora if mc.lora.use_lora else None
    with torch.inference_mode():
        enc = encode(params, mc, batch, compute_dtype=dtype)
        prefix, plens = build_prefix(params, mc, batch, enc, compute_dtype=dtype)
        B, T = prefix.shape[:2]
        dev = prefix.device
        hidden, cache = L.llama_apply(params["llm"], mc.llm, inputs_embeds=prefix,
                                      lengths=plens, lora=lora, compute_dtype=dtype,
                                      return_cache=True, cache_len=T + N, output="hidden")
        h_last = hidden[torch.arange(B, device=dev), plens.long() - 1][:, None]
        logits = L.compute_logits(params["llm"], mc.llm, h_last)[:, 0]
        del hidden
        V = logits.shape[-1]
        cache = L.KVCache(cache.k.repeat_interleave(W, 1), cache.v.repeat_interleave(W, 1))
        cur = plens.long().repeat_interleave(W)
        logits = logits.repeat_interleave(W, 0)
        scores = torch.full((B, W), -1e30, device=dev)
        scores[:, 0] = 0.0
        tokens = torch.zeros((B, W, N), dtype=torch.int64, device=dev)
        for step in range(N):
            flat = (scores[..., None]
                    + torch.log_softmax(logits, -1).reshape(B, W, V)).reshape(B, W * V)
            top = torch.sort(flat, dim=-1, descending=True, stable=True).indices[:, :W]
            scores = torch.gather(flat, -1, top)
            src, new = top // V, top % V
            gather = (torch.arange(B, device=dev)[:, None] * W + src).reshape(-1)
            cache = L.KVCache(cache.k[:, gather], cache.v[:, gather])
            cur = cur[gather]
            tokens = torch.take_along_dim(tokens, src[..., None], dim=1)
            tokens[:, :, step] = new
            if step + 1 < N:
                logits, cache = L.llama_decode_step(
                    params["llm"], mc.llm,
                    x=L.embed_tokens(params["llm"], new.reshape(-1)[:, None], dtype),
                    cache=cache, cur_lens=cur, lora=lora, compute_dtype=dtype)
                cur = cur + 1
        best = scores.argmax(-1)          # equal lengths: the best score
    return tokens[torch.arange(B, device=dev), best], scores


def split_step_logits(params, mc, hb, dtype, use_kernels, toks=None):
    """One prefill (kernels on) into an int8 prefix cache, then beam step 0
    (``llama_decode_step_split``, B x 5 rows) per ``use_kernels`` entry:
    {use_kernel: logits [B*5, V] f32}, and the step's tokens (each row's top
    5 of the prefill unless ``toks`` is given)."""
    import torch

    from avsr_tpu_torch.data.loader import featurize
    from avsr_tpu_torch.models import llama as L
    from avsr_tpu_torch.models.avsr import build_prefix, encode

    W = 5
    lora = mc.lora if mc.lora.use_lora else None
    with torch.inference_mode():
        batch = featurize(hb, "cuda", dtype)
        enc = encode(params, mc, batch, compute_dtype=dtype)
        prefix, lens = build_prefix(params, mc, batch, enc, compute_dtype=dtype)
        B, T = prefix.shape[:2]
        hidden, pre = L.llama_apply(params["llm"], mc.llm, inputs_embeds=prefix,
                                    lengths=lens, lora=lora, compute_dtype=dtype,
                                    return_cache=True, cache_len=-(-T // 128) * 128,
                                    output="hidden")
        pre = L.quantize_cache(pre)
        if toks is None:
            h_last = hidden[torch.arange(B, device=prefix.device), lens.long() - 1][:, None]
            lg = L.compute_logits(params["llm"], mc.llm, h_last, "never")[:, 0]
            toks = lg.topk(W, dim=-1).indices.reshape(-1)
        hd = mc.llm.d_model // mc.llm.n_heads
        shape = (mc.llm.n_layers, B * W, mc.llm.n_kv_heads, 128, hd)
        suf = L.KVCache(torch.zeros(shape, dtype=dtype, device="cuda"),
                        torch.zeros(shape, dtype=dtype, device="cuda"))
        emb = L.embed_tokens(params["llm"], toks[:, None], dtype)
        out = {uk: L.llama_decode_step_split(
            params["llm"], mc.llm, x=emb, prefix_cache=pre, suffix_cache=suf,
            prefix_lens=lens, step=0, lora=lora, compute_dtype=dtype, use_kernel=uk)[0]
            for uk in use_kernels}
    return out, toks


def logit_gates(tag: str, l32: dict, l16: dict) -> dict:
    """Phase 9's gates on one step's logits, kernel path ("auto") against
    the dequantize path ("never"): in f32 mean |d| within 1e-2 * std and
    max |d| no larger than the bf16 step's own distance from f32; in bf16
    the kernel path no further from f32 than 2x the dequantize path."""
    ref = l32["never"]
    std = ref.std().item()
    d32 = (l32["auto"] - ref).abs()
    dk, dn = (l16["auto"] - ref).abs(), (l16["never"] - ref).abs()
    c = dict(std_f32=std, f32_kernel_vs_dequant_max=d32.max().item(),
             f32_kernel_vs_dequant_mean=d32.mean().item(),
             bf16_kernel_vs_f32_mean=dk.mean().item(),
             bf16_dequant_vs_f32_mean=dn.mean().item(),
             bf16_dequant_vs_f32_max=dn.max().item(),
             top1_f32_kernel_vs_dequant=(l32["auto"].argmax(-1) == ref.argmax(-1))
             .float().mean().item())
    print(f"{tag} step logits " + json.dumps(c))
    check(c["f32_kernel_vs_dequant_mean"] <= 1e-2 * std,
          f"{tag} f32: kernel vs dequant mean|d| {c['f32_kernel_vs_dequant_mean']:.4e} "
          f"> 1e-2 * std {std:.4e}")
    check(c["f32_kernel_vs_dequant_max"] <= c["bf16_dequant_vs_f32_max"],
          f"{tag} f32: kernel vs dequant max|d| {c['f32_kernel_vs_dequant_max']:.4e} > "
          f"the bf16 step's own {c['bf16_dequant_vs_f32_max']:.4e}")
    check(c["bf16_kernel_vs_f32_mean"] <= 2.0 * c["bf16_dequant_vs_f32_mean"],
          f"{tag} bf16: kernel path mean|d| to f32 {c['bf16_kernel_vs_f32_mean']:.4e} > "
          f"2x the dequantize path's {c['bf16_dequant_vs_f32_mean']:.4e}")
    return c


def decode_variants_phase(seed: int, bf16: dict) -> dict:
    """Beam search, speculative decoding with its three drafts, the
    streaming continuation and the draft-distillation CLI at the
    flagship's full width (see the module docstring, phase 13)."""
    import shutil

    import torch

    from avsr_tpu_torch.cli import common, decode, distill
    from avsr_tpu_torch.convert import cast_tree
    from avsr_tpu_torch.core.config import flagship, save_config
    from avsr_tpu_torch.data.loader import featurize
    from avsr_tpu_torch.infer import speculative as S
    from avsr_tpu_torch.infer.generate import (beam_search, generate_continue,
                                               generate_tokens, prefill_extend,
                                               prepare_params_for_decode)
    from avsr_tpu_torch.models import llama as L
    from avsr_tpu_torch.models.avsr import build_prefix, encode
    from avsr_tpu_torch.train.checkpoint import export_params

    res: dict = {}
    by_path: dict[str, dict[str, int]] = {}
    cfg = flagship()
    mc = cfg.model
    nL, W, G = mc.llm.n_layers, 5, 4
    enc_layers = mc.whisper.n_layers
    hb = serving_host_batch(cfg, seed)
    B = len(hb.utt_ids)

    def run(tag: str, fn):
        """``fn()`` between a count reset and a reading: its launches go to
        ``launches_by_path[tag]``; returns (result, launches, seconds)."""
        torch.cuda.synchronize()
        before = counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        by_path[tag] = since(before)
        return out, by_path[tag], dt

    def want(flash=0, dq=0, dkv=0, int8=0, int4=0) -> dict[str, int]:
        return dict(flash_fwd=flash, flash_bwd_dq=dq, flash_bwd_dkv=dkv,
                    qmatmul_int8=int8, qmatmul_int4=int4)

    # ---- f32 exactness gates (TF32 is off for the whole script) ----------
    cfg32 = flagship(["runtime.compute_dtype=float32"])
    raw32 = common.init_or_load_params(cfg32, seed=seed, device="cuda")
    p32 = prepare_params_for_decode(raw32, mc)
    b32 = featurize(hb, "cuda", torch.float32)
    k32 = dict(eos_id=-1, compute_dtype=torch.float32)
    N32 = 32
    greedy32 = generate_tokens(p32, mc, b32, max_new_tokens=N32, **k32)
    st: dict = {}
    beam32, _, _ = run("beam_f32", lambda: beam_search(
        p32, mc, b32, max_new_tokens=N32, num_beams=W, stats=st, **k32))
    o_tok, o_scores = beam_oracle(p32, mc, b32, W, N32, torch.float32)
    rel = ((st["scores"] - o_scores).abs() / o_scores.abs()).max().item()
    check(torch.equal(beam32.tokens, o_tok),
          f"f32 beam (W={W}, {N32} tokens): split cache != flat-cache oracle, "
          f"{(beam32.tokens != o_tok).sum().item()} tokens differ")
    check(rel <= 1e-4, f"f32 beam scores off the oracle's by {rel:.3e} (relative 1e-4)")
    beam1 = beam_search(p32, mc, b32, max_new_tokens=N32, num_beams=1, **k32)
    check(torch.equal(beam1.tokens, greedy32.tokens), "f32 beam W=1 != greedy")
    print(f"beam f32: W={W} x {N32} tokens equal the flat-cache oracle token for token "
          f"(scores within {rel:.2e} relative); W=1 equals greedy")
    res["beam_f32"] = dict(oracle_scores_max_rel=rel, tokens_equal=True, w1_equals_greedy=True)

    spec32 = {}
    drafts32 = {"int8": (S.make_draft_params(raw32, mc, bits=8), None, 8),
                "int4": (S.make_draft_params(raw32, mc, bits=4), None, 4)}
    d_raw, dcfg = S.make_layerskip_draft(raw32, mc, 8)
    drafts32["layerskip8"] = (S.make_draft_params(d_raw, dcfg, bits=8), dcfg, 8)
    del d_raw
    for name, (dp, dc, bits) in drafts32.items():
        (out, sst), n, _ = run(f"spec_f32_{name}", lambda: S.speculative_generate(
            p32, dp, mc, b32, gamma=G, max_new_tokens=N32, return_stats=True,
            draft_model_cfg=dc, **k32))
        check(torch.equal(out.tokens, greedy32.tokens) and torch.equal(out.lengths, greedy32.lengths),
              f"f32 speculative ({name} draft) != greedy: "
              f"{(out.tokens != greedy32.tokens).sum().item()} tokens differ")
        Ld = dc.llm.n_layers if dc else nL
        per = (4 * Ld + 1) * sst["draft_steps"]
        w = want(flash=enc_layers + nL + Ld, int8=per if bits == 8 else 0,
                 int4=per if bits == 4 else 0)
        check(n == w, f"f32 speculative ({name}) launches {n}, expected {w}")
        spec32[name] = dict(sst, launches=n)
    print(f"speculative f32 (gamma {G}, {N32} tokens): int8, int4 and 8-layer "
          f"layer-skip drafts equal greedy token for token; " + json.dumps(spec32))
    res["spec_f32"] = spec32
    del drafts32, dp        # a draft shares the f32 tree's encoders and embedding

    # streaming continuation: freeze the first 7/16 of the prefix (233 of
    # the flagship's 533 rows), decode from the rest
    with torch.inference_mode():
        def stream():
            nonlocal Sf
            enc = encode(p32, mc, b32, compute_dtype=torch.float32)
            prefix, plens = build_prefix(p32, mc, b32, enc, compute_dtype=torch.float32)
            Sf = int(plens.min()) * 7 // 16
            M = -(-(prefix.shape[1] + N32) // 128) * 128
            cache = L.init_cache(mc.llm, B, M, torch.float32, "cuda")
            base = torch.full((B,), Sf, dtype=torch.int32, device="cuda")
            cache = prefill_extend(p32, mc, cache, torch.zeros_like(base),
                                   prefix[:, :Sf], base, compute_dtype=torch.float32)
            return generate_continue(p32, mc, cache, base, prefix[:, Sf:], plens - Sf,
                                     max_new_tokens=N32, eos_id=-1,
                                     compute_dtype=torch.float32)[0]
        Sf = 0
        cont, n, _ = run("stream_f32", stream)
    check(torch.equal(cont.tokens, greedy32.tokens),
          f"f32 generate_continue over a prefix frozen at {Sf} rows != generate_tokens")
    check(n == want(flash=enc_layers), f"stream launches {n}")
    print(f"stream f32: prefill_extend of {Sf} rows + generate_continue equals "
          f"generate_tokens over the whole prefix ({N32} tokens)")
    res["stream_f32"] = dict(frozen_rows=Sf, tokens_equal=True)
    del p32, b32, raw32
    settle()

    # ---- bf16 and the serving preset: beam numbers, exact launches --------
    # 32 tokens (the flagship decodes 100): this part's depth is cut so that
    # the whole script keeps to its time limit
    N = 32
    batch = featurize(hb, "cuda", torch.bfloat16)
    k16 = dict(eos_id=-1, compute_dtype=torch.bfloat16)
    beams = {}
    for tag, over in (("beam_bf16", ()), ("beam_preset", PRESET_OVERRIDES)):
        c = flagship(list(over))
        params = common.load_decode_params(c, seed=seed, device="cuda")
        kw = dict(num_beams=W, kv_cache_dtype=c.decode.kv_cache_dtype, **k16)
        beam_search(params, c.model, batch, max_new_tokens=4, **kw)     # warm-up
        torch.cuda.reset_peak_memory_stats()
        stb: dict = {}
        out, n, _ = run(tag, lambda: beam_search(params, c.model, batch, max_new_tokens=N,
                                                 stats=stb, **kw))
        steps = stb["decode_steps"]
        q = tag == "beam_preset"
        w = want(flash=enc_layers + nL, int8=steps + 1 if q else 0,
                 int4=4 * nL * steps if q else 0)
        check(n == w, f"{tag} launches {n}, expected {w}")
        check(out.tokens.shape == (B, N) and bool((out.lengths == N).all()), f"{tag} tokens")
        check(bool(torch.isfinite(stb["scores"]).all()), f"{tag} scores not finite")
        tot = stb["encode_s"] + stb["prefill_s"] + stb["decode_s"]
        beams[tag] = dict(config="flagship + " + " ".join(over), batch=B, beams=W,
                          max_new_tokens=N, encode_ms=stb["encode_s"] * 1e3,
                          prefill_ms=stb["prefill_s"] * 1e3, decode_steps=steps,
                          ms_per_step=stb["decode_s"] * 1e3 / steps,
                          new_tokens_per_s=B * N / tot,
                          peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, launches=n)
        if q:
            p32q = cast_tree(params, torch.float32)
            l32, toks = split_step_logits(p32q, c.model, hb, torch.float32, ("auto", "never"))
            del p32q
            torch.cuda.empty_cache()
            l16, _ = split_step_logits(params, c.model, hb, torch.bfloat16,
                                       ("auto", "never"), toks)
            beams[tag]["step_logits"] = logit_gates("beam preset", l32, l16)
        del params
        settle()
    beams["greedy_bf16_phase3"] = dict(encode_ms=bf16["encode_ms"],
                                       prefill_ms=bf16["prefill_ms"],
                                       ms_per_step=bf16["ms_per_token"],
                                       new_tokens_per_s=bf16["new_tokens_per_s"],
                                       peak_mem_gb=bf16["peak_mem_gb"])
    print("beam: " + json.dumps(beams))
    res["beam"] = beams

    # ---- speculative decoding in bf16: numbers beside greedy ---------------
    params, raw = common.load_decode_params(cfg, seed=seed, device="cuda", return_raw=True)
    generate_tokens(params, mc, batch, max_new_tokens=4, **k16)                # warm-up
    g16, _, g_s = run("greedy_bf16", lambda: generate_tokens(params, mc, batch,
                                                             max_new_tokens=N, **k16))
    del by_path["greedy_bf16"]             # phase 3's path, timed here as the yardstick
    spec = {"greedy_bf16": dict(ms_per_token=g_s * 1e3 / N, new_tokens_per_s=B * N / g_s)}
    layer_raw, lcfg = S.make_layerskip_draft(raw, mc, 8)
    for name, bits, dc, src in (("int8", 8, None, raw), ("int4", 4, None, raw),
                                ("layerskip8", 8, lcfg, layer_raw)):
        dp = S.make_draft_params(src, dc or mc, bits=bits)
        kw = dict(gamma=G, return_stats=True, draft_model_cfg=dc, **k16)
        S.speculative_generate(params, dp, mc, batch, max_new_tokens=4, **kw)  # warm-up
        (out, sst), n, secs = run(f"spec_bf16_{name}", lambda: S.speculative_generate(
            params, dp, mc, batch, max_new_tokens=N, **kw))
        Ld = dc.llm.n_layers if dc else nL
        per = (4 * Ld + 1) * sst["draft_steps"]
        w = want(flash=enc_layers + nL + Ld, int8=per if bits == 8 else 0,
                 int4=per if bits == 4 else 0)
        check(n == w, f"bf16 speculative ({name}) launches {n}, expected {w}")
        check(out.tokens.shape == (B, N) and bool(((out.tokens >= 0)
                                                   & (out.tokens < mc.llm.vocab_size)).all()),
              f"bf16 speculative ({name}) tokens")
        spec[name] = dict(sst, ms_per_token=secs * 1e3 / N, new_tokens_per_s=B * N / secs,
                          launches=n, token_agreement_with_greedy=(
                              out.tokens == g16.tokens).float().mean().item())
        if name == "int8":
            def sampled(s):
                return S.speculative_generate(
                    params, dp, mc, batch, gamma=G, max_new_tokens=N, temperature=0.7,
                    top_p=0.9, eos_id=-1, compute_dtype=torch.bfloat16,
                    generator=torch.Generator(device="cuda").manual_seed(s)).tokens
            a, b = sampled(seed + 11), sampled(seed + 11)
            check(torch.equal(a, b), "sampled speculative: one seed, two streams")
            spec["sampled_t0.7_same_seed_equal"] = True
        del dp
        torch.cuda.empty_cache()
    print("speculative bf16: " + json.dumps(spec))
    res["spec_bf16"] = spec
    del params, raw, layer_raw
    settle()

    # ---- distillation, and decoding with the distilled draft ---------------
    work = ROOT / "outputs" / "chip_smoke" / time.strftime("distill_%Y%m%d_%H%M%S")
    try:
        teacher = common.init_params(cfg, seed=seed, device="cuda")
        export_params(teacher, work / "teacher")
        del teacher
        save_config(cfg, work / "teacher.yaml")
        settle()
        flag = list(FLAGSHIP_OVERRIDES)
        student = ["model.llm.n_layers=4", "model.freeze_llm=false",
                   "model.lora.use_lora=false", "data.synthetic=true",
                   "training.max_steps=2", "training.log_interval=1"]
        rec = _Records()
        logging.getLogger("avsr_tpu_torch").addHandler(rec)
        torch.cuda.reset_peak_memory_stats()
        try:
            rc, n, secs = run("distill_cli", lambda: distill.main([
                "--seed", str(seed), "--device", "cuda",
                "--teacher-config", str(work / "teacher.yaml"),
                "--teacher-checkpoint", str(work / "teacher"),
                "--out", str(work / "draft"), *flag, *student]))
        finally:
            logging.getLogger("avsr_tpu_torch").removeHandler(rec)
        check(rc == 0, f"distill CLI returned {rc}")
        peak = torch.cuda.max_memory_allocated() / 1e9
        stamps = [r.created for r in rec.records if str(r.msg).startswith("step %d/%d")]
        check(len(stamps) == 2, f"distill CLI logged {len(stamps)} steps, not 2")
        per_step = want(flash=2 * enc_layers + nL + 4, dq=4, dkv=4)
        check(n == {k: 2 * v for k, v in per_step.items()},
              f"distill launches {n} over 2 steps, expected 2 x {per_step}")
        report = json.loads((work / "draft" / "distill_report.json").read_text())
        check(np.isfinite(report["loss"]), "distill loss not finite")
        res["distill"] = dict(step2_ms=(stamps[1] - stamps[0]) * 1e3, cli_s=secs,
                              peak_mem_gb=peak, launches_per_step=per_step, report=report)
        shutil.rmtree(work / "teacher")
        settle()

        f32 = ["runtime.compute_dtype=float32"]
        spec_run = ["decode.speculative=true",
                    f"decode.spec_draft_checkpoint={work / 'draft'}",
                    f"decode.spec_draft_config={work / 'draft' / 'config.yaml'}"]
        hyps = {}
        for tag, extra in (("greedy", f32), ("speculative", f32 + spec_run)):
            out_dir = work / f"decode_{tag}"
            _, n, _ = run(f"distill_decode_{tag}", lambda: cli_phase(
                seed, tuple(extra), tag=f"distill_{tag}", out_dir=out_dir))
            text = next(out_dir.glob("results_*.txt")).read_text()
            hyps[tag] = [line for line in text.splitlines() if line.startswith("HYP")]
        check(hyps["greedy"] == hyps["speculative"],
              "decode CLI with the distilled draft: HYP lines differ from greedy's")
        c = flagship(f32 + spec_run + ["data.synthetic=true", "data.synthetic_size=40",
                                       "decode.max_new_tokens=16"])
        tp, dp, dc = decode.load_draft(c, None, seed=seed, device=torch.device("cuda"))
        b = featurize(hb, "cuda", torch.float32)
        (out, sst), n, _ = run("distill_spec_stats", lambda: S.speculative_generate(
            tp, dp, c.model, b, gamma=G, max_new_tokens=16, eos_id=-1,
            compute_dtype=torch.float32, return_stats=True, draft_model_cfg=dc,
            draft_shares_prefix=False))
        w = want(flash=2 * enc_layers + nL + 4, int8=(4 * 4 + 1) * sst["draft_steps"])
        check(n == w, f"speculative with the distilled draft: launches {n}, expected {w}")
        res["distill"]["decode"] = dict(hyp_lines_equal=True, utterances=len(hyps["greedy"]),
                                        spec_stats=sst)
        del tp, dp
        print("distill: " + json.dumps(res["distill"]))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    settle()

    # ---- kernel rows at the new shapes --------------------------------------
    gen = torch.Generator(device="cuda").manual_seed(seed + 13)
    steps = beams["beam_preset"]["decode_steps"]
    rows = []
    for bits in (4, 8):
        for name, K, Nn in (("qkv", 2048, 3072), ("o", 2048, 2048), ("gateup", 2048, 16384),
                            ("down", 8192, 2048), ("lm_head", 2048, 129024)):
            on_path = (bits == 4 and name != "lm_head") or (bits == 8 and name == "lm_head")
            by_call = {"beam_preset": (nL if bits == 4 else 1) * steps} if on_path else {}
            rows.append(qmm_row(name, bits, W * B, K, Nn, by_call, gen))
    spec4 = res["spec_bf16"]["int4"]["draft_steps"]
    rows.append(qmm_row("lm_head", 4, B, 2048, 129024, {"spec_bf16_int4": spec4}, gen))
    res["qmm_rows"] = rows
    res["launches_by_path"] = by_path
    res["launches"] = {k: sum(p[k] for p in by_path.values()) for k in counts()}
    print("decode variants: launches " + json.dumps(by_path))
    return res


# ---------------------------------------------------------------------------
# Phase 14: serving (the engine, the multi-LoRA bank, speculative slots, the
# HTTP server and streaming transcription)
# ---------------------------------------------------------------------------

def serving_traffic(seed: int, n: int = 32, audio_only: bool = False):
    """``n`` requests of 4-10 s synthetic audio (+ 25 frames) and their
    budgets, 10-100 new tokens, from ``seed``."""
    from avsr_tpu_torch.data.dataset import Sample

    rng = np.random.default_rng(seed + 1400)
    samples, budgets = [], []
    for i in range(n):
        ns = int(rng.integers(4 * 16000, 10 * 16000 + 1))
        t = np.arange(ns, dtype=np.float32) / 16000.0
        audio = (0.3 * np.sin(2 * np.pi * rng.uniform(80, 300) * t)
                 + 0.05 * rng.standard_normal(ns)).astype(np.float32)
        frames = (None if audio_only
                  else rng.integers(0, 256, (25, 224, 224, 3), dtype=np.uint8))
        samples.append(Sample(f"serve/{i}", audio, frames, "", [257]))
        budgets.append(int(rng.integers(10, 101)))
    return samples, budgets


def pct(xs, q: float) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q))


def drive_engine(eng, samples, budgets, adapters=None, mid=None) -> dict:
    """Submit every request at once and step the engine until all finish:
    tokens per request, each one's latency and time to its first token on
    the host (seconds from the submit), and the wall time. ``mid``, when
    given, runs after the first step (a mid-flight action) and returns
    more (sample, budget, adapter) requests to submit then."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    aids = adapters or [0] * len(samples)
    ids = [eng.submit(s, max_new=b, adapter=a) for s, b, a in zip(samples, budgets, aids)]
    first: dict[int, float] = {}
    fin_t: dict[int, float] = {}
    out: dict[int, list[int]] = {}
    steps = 0
    while eng.outstanding():
        fin = eng.step()
        steps += 1
        t = time.perf_counter() - t0
        if mid is not None and steps == 1:
            ids += [eng.submit(s, max_new=b, adapter=a) for s, b, a in mid()]
        seen = ([(rid, r.tokens) for rid, r in eng._reqs.items()]
                + [(st.req, st.tokens) for st in eng.slots if st.req is not None])
        for rid, toks in seen:
            if toks and rid not in first:
                first[rid] = t
        for rid, toks in fin.items():
            out[rid], fin_t[rid] = toks, t
            first.setdefault(rid, t)
            eng.collect(rid)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return dict(tokens=[out[i] for i in ids], latency=[fin_t[i] for i in ids],
                ttft=[first[i] for i in ids], wall=wall)


def static_batches(params, cfg, samples, budgets, dtype, kv: str = "bfloat16",
                   B: int = 8) -> dict:
    """The same requests as static ``generate_tokens`` batches of ``B`` in
    submit order, each decoding to its largest budget; a request's tokens
    are its row cut to its budget (and EOS), its latency and first token
    the end of its batch's call."""
    import torch

    from avsr_tpu_torch.data.loader import collate, featurize
    from avsr_tpu_torch.data.tokenizer import ByteTokenizer
    from avsr_tpu_torch.infer.generate import generate_tokens

    tok = ByteTokenizer()
    mc = cfg.model
    prompt = tok.encode(mc.prompt, add_bos=True)
    toks, lat = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in range(0, len(samples), B):
        group, bud = samples[s:s + B], budgets[s:s + B]
        batch = featurize(collate(group, cfg.data, prompt, tok.pad_id), "cuda", dtype, mc)
        out = generate_tokens(params, mc, batch, max_new_tokens=max(bud), eos_id=tok.eos_id,
                              compute_dtype=dtype, kv_cache_dtype=kv)
        rows, lens = out.tokens.tolist(), out.lengths.tolist()
        t = time.perf_counter() - t0
        for r, n, b in zip(rows, lens, bud):
            toks.append(r[: min(n, b)])
            lat.append(t)
    return dict(tokens=toks, latency=lat, ttft=lat, wall=time.perf_counter() - t0)


def serving_numbers(run: dict, n_slots: int | None = None, eng=None) -> dict:
    new = sum(len(t) for t in run["tokens"])
    res = dict(requests=len(run["tokens"]), new_tokens=new, wall_s=run["wall"],
               utterances_per_s=len(run["tokens"]) / run["wall"],
               new_tokens_per_s=new / run["wall"],
               latency_p50_s=pct(run["latency"], 50), latency_p95_s=pct(run["latency"], 95),
               ttft_p50_s=pct(run["ttft"], 50), ttft_p95_s=pct(run["ttft"], 95))
    if eng is not None:
        st = eng.stats()
        res.update(stats=st, steps_launched=eng.steps_launched,
                   slot_occupancy=st["tokens_emitted"] / max(eng.slot_capacity, 1),
                   steps_past_last_finish=eng.steps_launched - eng.decode_steps_total)
    return res


def token_share(a: list[list[int]], b: list[list[int]]) -> float:
    """The share of token positions where two runs agree (over the longer
    of each pair)."""
    same = sum(sum(x == y for x, y in zip(p, q)) for p, q in zip(a, b))
    return same / max(sum(max(len(p), len(q)) for p, q in zip(a, b)), 1)


def engine_step_logits(params, cfg, samples, dtype, use_kernels) -> dict:
    """The engine's decode step at its own shapes: ``stage`` of up to 8
    requests into int8 rows of the slot cache's width (M = 3200), then one
    ``llama_decode_step`` per ``use_kernels`` entry on copies of those rows
    from the staged first tokens: {use_kernel: logits [S, V] f32}."""
    import torch

    from avsr_tpu_torch.data.loader import collate, featurize
    from avsr_tpu_torch.data.tokenizer import ByteTokenizer
    from avsr_tpu_torch.infer.engine import stage
    from avsr_tpu_torch.models import llama as L

    tok = ByteTokenizer()
    mc = cfg.model
    hb = collate(samples, cfg.data, tok.encode(mc.prompt, add_bos=True), tok.pad_id)
    S = len(samples)
    with torch.inference_mode():
        rows, tok0, plens = stage(
            params, mc, featurize(hb, "cuda", dtype), torch.zeros(S, device="cuda"),
            torch.ones(S, device="cuda"), cache_len=3200, quantize=True, compute_dtype=dtype)
        emb = L.embed_tokens(params["llm"], tok0[:, None], dtype)
        out = {}
        for uk in use_kernels:
            c = L.KVCache(*(t.clone() for t in rows))
            out[uk] = L.llama_decode_step(params["llm"], mc.llm, x=emb, cache=c, cur_lens=plens,
                                          lora=mc.lora, compute_dtype=dtype, use_kernel=uk)[0]
    return out


def serving_phase(seed: int, bf16: dict) -> dict:
    """The serving engine, the multi-LoRA bank, speculative slots, the
    HTTP server and streaming transcription at the flagship's full width
    (see the module docstring, phase 14)."""
    import threading
    import urllib.error
    import urllib.request

    import torch

    from avsr_tpu_torch.cli import common
    from avsr_tpu_torch.convert import cast_tree
    from avsr_tpu_torch.core.config import flagship
    from avsr_tpu_torch.data.dataset import Sample
    from avsr_tpu_torch.data.loader import collate, featurize
    from avsr_tpu_torch.data.tokenizer import ByteTokenizer
    from avsr_tpu_torch.infer import adapters as ad
    from avsr_tpu_torch.infer import speculative as S
    from avsr_tpu_torch.infer.engine import ServingEngine
    from avsr_tpu_torch.infer.generate import beam_search, generate_tokens
    from avsr_tpu_torch.infer.generate import prepare_params_for_decode
    from avsr_tpu_torch.infer.server import AVSRServer
    from avsr_tpu_torch.infer.streaming import StreamingTranscriber
    from avsr_tpu_torch.models import llama as L

    tok = ByteTokenizer()
    res: dict = {}
    by_path: dict[str, dict[str, int]] = {}
    # 16 requests, which keeps the script within its time limit
    samples, budgets = serving_traffic(seed, 16)
    base_alloc = torch.cuda.memory_allocated()
    half = 16
    nW, nL = 24, 16                      # Whisper and LLM layers: flash per encode/prefill

    def counted(tag: str, fn):
        torch.cuda.synchronize()
        before = counts()
        out = fn()
        torch.cuda.synchronize()
        by_path[tag] = since(before)
        return out

    def want(flash=0, int8=0, int4=0) -> dict[str, int]:
        return dict(flash_fwd=flash, flash_bwd_dq=0, flash_bwd_dkv=0, qmatmul_int8=int8,
                    qmatmul_int4=int4)

    def engine(params, cfg, **kw):
        eng = ServingEngine(params, cfg, tok, num_slots=8, k_steps=16,
                            seed=cfg.training.seed, **kw)
        eng.warmup(samples[0])
        settle()
        print(f"serving: {torch.cuda.memory_allocated() / 1e9:.3f} GB allocated before "
              "the run (weights, the slot cache)")
        check(eng.M == 3200, f"slot cache width {eng.M}, expected 33 + 3000 + 100 -> 3200")
        return eng

    # ---- f32: the engine's contract, the bank, speculative slots, streaming --
    cfg32 = flagship(["runtime.compute_dtype=float32"])
    mc = cfg32.model
    t0 = time.perf_counter()
    raw32 = common.init_or_load_params(cfg32, seed=seed, device="cuda")
    p32 = prepare_params_for_decode(raw32, mc)
    print(f"serving f32: init and decode layout in {time.perf_counter() - t0:.2f} s")

    eng = engine(p32, cfg32)
    run = counted("engine_f32", lambda: drive_engine(eng, samples, budgets))
    ref = static_batches(p32, cfg32, samples, budgets, torch.float32)
    diff = [i for i, (a, b) in enumerate(zip(run["tokens"], ref["tokens"])) if a != b]
    check(not diff, f"f32 engine != generate_tokens for requests {diff}")
    n = by_path["engine_f32"]
    check(n == want(flash=(nW + nL) * eng.stages_run),
          f"f32 engine launches {n}, expected 40 per stage x {eng.stages_run}")
    res["engine_f32"] = dict(serving_numbers(run, eng=eng), tokens_equal_generate_tokens=True,
                             launches=n)
    greedy32 = run["tokens"]
    print(f"serving f32 engine: {len(samples)} requests equal generate_tokens token for token; "
          + json.dumps(res["engine_f32"]["stats"]))
    eng.close()
    del eng, ref
    settle()

    # speculative slots: the int8 self-draft, gamma 4, token-equal to greedy
    draft = S.make_draft_params(raw32, mc, bits=8)
    eng = ServingEngine(p32, cfg32, tok, num_slots=8, seed=seed, draft_params=draft,
                        spec_gamma=4, spec_rounds=4)
    eng.warmup(samples[0])
    run = counted("engine_spec_f32", lambda: drive_engine(eng, samples[:half], budgets[:half]))
    diff = [i for i, (a, b) in enumerate(zip(run["tokens"], greedy32[:half])) if a != b]
    check(not diff, f"f32 speculative slots != the greedy engine for requests {diff}")
    n = by_path["engine_spec_f32"]
    w = want(flash=2 * (nW + nL) * eng.stages_run,
             int8=(4 * nL + 1) * eng.draft_steps + eng.stages_run)
    check(n == w, f"speculative engine launches {n}, expected {w}")
    st = eng.stats()
    res["engine_spec_f32"] = dict(
        serving_numbers(run), stats=st, draft_steps=eng.draft_steps, launches=n,
        verify_passes=eng.chunks_run * eng.spec_rounds,
        tokens_per_verify_pass=(st["tokens_emitted"] - st["requests_done"])
        / max(eng.spec_slot_rounds, 1), tokens_equal_greedy_engine=True)
    print("serving f32 speculative slots: " + json.dumps(res["engine_spec_f32"]))
    eng.close()
    del eng, draft
    settle()

    # multi-LoRA: 3 adapters with nonzero b plus the base in the bank, and a
    # fourth onboarded mid-flight (the bank doubles from 4 rows to 8)
    gen = torch.Generator(device="cuda").manual_seed(seed + 14)
    skel = ad.extract_lora(raw32["llm"])
    tenants = [ad.random_adapter_like(skel, gen, std=0.02) for _ in range(4)]
    eng = ServingEngine(raw32, cfg32, tok, num_slots=8, seed=seed,
                        adapter_bank=ad.stack_lora_bank([skel] + tenants[:3]))
    eng.warmup(samples[0])
    lora_s, lora_b = samples[:half], budgets[:half]
    aids = [i % 4 for i in range(12)]
    late = [(lora_s[i], lora_b[i], 4) for i in range(12, half)]

    def onboard():
        check(eng.add_adapter(tenants[3]) == 4, "add_adapter mid-flight: not row 4")
        return late

    run = counted("engine_lora_f32", lambda: drive_engine(eng, lora_s[:12], lora_b[:12],
                                                          aids, mid=onboard))
    aids += [4] * len(late)
    rows = [skel] + tenants
    for a in range(5):
        idx = [i for i in range(half) if aids[i] == a]
        p = {**raw32, "llm": ad.inject_lora(raw32["llm"], rows[a])}
        want_a = static_batches(p, cfg32, [lora_s[i] for i in idx], [lora_b[i] for i in idx],
                                torch.float32)
        diff = [i for i, t in zip(idx, want_a["tokens"]) if run["tokens"][i] != t]
        check(not diff, f"multi-LoRA: requests {diff} of adapter {a} != generate_tokens "
                        "with that adapter")
    moved = token_share(run["tokens"][:12], greedy32[:12])
    n = by_path["engine_lora_f32"]
    check(n == want(flash=(nW + nL) * eng.stages_run), f"multi-LoRA launches {n}")
    res["engine_lora_f32"] = dict(serving_numbers(run, eng=eng), adapters=5, onboarded=1,
                                  tokens_equal_generate_tokens_with_adapter=True,
                                  token_share_equal_to_base=moved, launches=n)
    print("serving f32 multi-LoRA: 16 requests over 5 bank rows equal generate_tokens "
          "with their adapter; " + json.dumps(res["engine_lora_f32"]["stats"]))
    eng.close()
    del eng, tenants, rows, skel, p, want_a
    settle()

    # streaming, exact mode: 10 s in 1 s chunks, no commit before finalize
    st_cfg = flagship(["runtime.compute_dtype=float32", "decode.max_new_tokens=32"])
    hb10 = serving_host_batch(st_cfg, seed + 14, B=1)
    audio10, frames10 = hb10.audio[0], None
    rng = np.random.default_rng(seed + 15)
    frames10 = rng.integers(0, 256, (25, 224, 224, 3), dtype=np.uint8)

    def feeds():
        return [dict(audio=audio10[i * 16000:(i + 1) * 16000],
                     frames=frames10[i * 25 // 10:(i + 1) * 25 // 10]) for i in range(10)]

    def stream(params, cfg, agree):
        stt = StreamingTranscriber(params, cfg, tok, agree_n=agree)
        prev, ms = [], []
        for kw in feeds():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stt.feed(**kw)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            check(stt.committed_tokens[: len(prev)] == prev, "streaming retracted a commit")
            prev = stt.committed_tokens
        stt.finalize()
        check(stt.committed_tokens[: len(prev)] == prev, "finalize retracted a commit")
        return stt, ms

    stt, _ = counted("stream_exact_f32", lambda: stream(p32, st_cfg, 11))
    b1 = featurize(collate([Sample("x", audio10, frames10, "", [tok.eos_id])], st_cfg.data,
                           tok.encode(mc.prompt, add_bos=True), tok.pad_id), "cuda",
                   torch.float32)
    off = generate_tokens(p32, mc, b1, max_new_tokens=32, eos_id=tok.eos_id)
    off_ids = off.tokens[0, : int(off.lengths[0])].tolist()
    off_ids = off_ids[:-1] if off_ids and off_ids[-1] == tok.eos_id else off_ids
    check(stt.committed_tokens == off_ids, "f32 streaming finalize != the offline decode")
    n = by_path["stream_exact_f32"]
    check(n == want(flash=(nW + nL) * 11), f"exact streaming launches {n}, expected 40 x 11")
    res["stream_exact_f32"] = dict(finalize_equals_offline=True, feeds=10,
                                   committed=len(stt.committed_tokens), launches=n)
    print("serving stream_exact_f32: finalize equals the offline decode; "
          + json.dumps(res["stream_exact_f32"]))
    del p32, raw32, stt, b1, off
    settle()
    left = (torch.cuda.memory_allocated() - base_alloc) / 1e9
    check(left < 1.0, f"{left:.2f} GB of the f32 part still allocated")

    # ---- bf16: the engine beside static batches, streaming, cache width ------
    cfg = flagship()
    params = common.load_decode_params(cfg, seed=seed, device="cuda")
    eng = engine(params, cfg)
    torch.cuda.reset_peak_memory_stats()
    run = counted("engine_bf16", lambda: drive_engine(eng, samples, budgets))
    peak = torch.cuda.max_memory_allocated() / 1e9
    n = by_path["engine_bf16"]
    check(n == want(flash=(nW + nL) * eng.stages_run), f"bf16 engine launches {n}")
    out16 = serving_numbers(run, eng=eng)
    step_ms = run["wall"] * 1e3 / max(eng.steps_launched, 1)
    eng.close()
    del eng
    settle()
    torch.cuda.reset_peak_memory_stats()
    ref = static_batches(params, cfg, samples, budgets, torch.bfloat16)
    res["engine_bf16"] = dict(out16, peak_mem_gb=peak, launches=n,
                              ms_per_step_of_the_run=step_ms,
                              token_share_equal_to_static=token_share(run["tokens"],
                                                                      ref["tokens"]),
                              static_batches=dict(serving_numbers(ref),
                                                  peak_mem_gb=torch.cuda.max_memory_allocated()
                                                  / 1e9))
    print("serving bf16 engine vs static batches: " + json.dumps(res["engine_bf16"]))

    # what a decode step pays for the slot cache's width: the plain decode
    # attention of one layer (8 rows, 32 q and 8 kv heads of 64, bf16) over
    # M = 640 (a static call's ceil128(533 + 100)) and M = 3200 columns,
    # 520 of them valid, from a replayed CUDA graph, x 16 layers; and whole
    # eager steps, where the host's launch pace hides it
    with torch.inference_mode():
        g = torch.Generator(device="cuda").manual_seed(seed + 16)
        q = torch.randn((8, 32, 1, 64), generator=g, device="cuda", dtype=torch.bfloat16)
        x = torch.randn((8, 1, 2048), generator=g, device="cuda", dtype=torch.bfloat16)
        cur = torch.full((8,), 520, device="cuda")
        width = {}
        for M in (640, 3200):
            kv = [torch.randn((8, 8, M, 64), generator=g, device="cuda", dtype=torch.bfloat16)
                  for _ in range(2)]
            attn = graph_ms([lambda: L._gqa_decode_attention(q, *kv, kv_lens=cur + 1)])
            c = L.init_cache(cfg.model.llm, 8, M, torch.bfloat16, "cuda")
            step = time_ms(lambda: L.llama_decode_step(
                params["llm"], cfg.model.llm, x=x, cache=c, cur_lens=cur, lora=cfg.model.lora,
                compute_dtype=torch.bfloat16), 20)
            width[M] = dict(attention_ms_per_layer=attn, attention_ms_per_step=nL * attn,
                            eager_step_ms=step)
            del kv, c
    res["cache_width"] = dict(
        M640=width[640], M3200=width[3200],
        extra_device_ms_per_step=width[3200]["attention_ms_per_step"]
        - width[640]["attention_ms_per_step"],
        times_are="attention: replayed CUDA graph; eager_step_ms: CUDA events around 20 "
                  "eager bf16 decode steps of 8 rows (the host's launch pace included)")
    print("serving cache width: " + json.dumps(res["cache_width"]))

    # streaming in bf16: ms per 1 s chunk, exact and blockwise (2 s blocks)
    for tag, over in (("stream_exact_bf16", []),
                      ("stream_block_bf16", ["decode.stream_block_s=2",
                                             "decode.stream_video_fps=2.5"])):
        c = flagship(["decode.max_new_tokens=32", *over])
        stt, ms = counted(tag, lambda: stream(params, c, 2))
        n = by_path[tag]
        blocks = stt._frozen_samples // 32000
        w = (want(flash=(nW + nL) * 11) if not over
             else want(flash=nW * (blocks + 11)))
        check(n == w, f"{tag} launches {n}, expected {w}")
        if over:
            check(blocks > 0 and stt._frozen_frames == 5 * blocks,
                  f"blockwise streaming froze {blocks} audio blocks and "
                  f"{stt._frozen_frames} frames")
        res[tag] = dict(ms_per_chunk=ms, ms_per_chunk_mean=float(np.mean(ms)),
                        committed=len(stt.committed_tokens), frozen_blocks=blocks,
                        launches=n)
        print(f"serving {tag}: " + json.dumps(res[tag]))
        del stt
    del params
    settle()

    # ---- the preset and use_8bit engines beside static batches --------------
    for tag, over, bits in (("engine_preset", PRESET_OVERRIDES, 4),
                            ("engine_8bit", INT8_OVERRIDES, 8)):
        c = flagship(list(over))
        params = common.load_decode_params(c, seed=seed, device="cuda")
        eng = engine(params, c)
        torch.cuda.reset_peak_memory_stats()
        run = counted(tag, lambda: drive_engine(eng, samples, budgets))
        peak = torch.cuda.max_memory_allocated() / 1e9
        k = eng.steps_launched
        proj = 4 * nL * k
        w = want(flash=(nW + nL) * eng.stages_run,
                 int8=k + eng.stages_run + (proj if bits == 8 else 0),
                 int4=proj if bits == 4 else 0)
        n = by_path[tag]
        check(n == w, f"{tag} launches {n}, expected {w}")
        nums = dict(serving_numbers(run, eng=eng), peak_mem_gb=peak, launches=n,
                    launches_per_step=dict(int4=4 * nL if bits == 4 else 0,
                                           int8=1 + (4 * nL if bits == 8 else 0)))
        eng.close()
        del eng
        settle()
        ref = static_batches(params, c, samples, budgets, torch.bfloat16, kv="int8")
        nums.update(token_share_equal_to_static=token_share(run["tokens"], ref["tokens"]),
                    static_batches=serving_numbers(ref))
        if bits == 4:
            # the engine's decode step (M = S = 8, the int8 slot cache's
            # width) against the dequantize path, with phase 9's gates
            p32q = cast_tree(params, torch.float32)
            l32 = engine_step_logits(p32q, c, samples[:8], torch.float32, ("auto", "never"))
            del p32q
            torch.cuda.empty_cache()
            l16 = engine_step_logits(params, c, samples[:8], torch.bfloat16, ("auto", "never"))
            nums["step_logits"] = logit_gates("engine preset", l32, l16)
        res[tag] = nums
        print(f"serving {tag}: " + json.dumps(nums))
        del params
        settle()

    # ---- the HTTP server: 16 clients and a beam client, f32 then bf16 --------
    aud_s, aud_b = serving_traffic(seed, half, audio_only=True)
    beam_sample = aud_s[0]

    def post(port, body, timeout=600):
        req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/transcribe",
                                     data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return json.loads(r.read())

    def serve(dtype_over, tag):
        c = flagship(["model.modality=audio", *dtype_over])
        params = common.load_decode_params(c, seed=seed, device="cuda")
        warm = Sample("warmup", np.zeros(16000, np.float32), None, "", [tok.eos_id])
        srv = AVSRServer(params, c, tok, port=0, num_slots=8, warmup_sample=warm,
                         request_timeout_s=600.0)
        out: dict = {}
        try:
            t_ready = time.perf_counter()
            srv.start()
            print(f"serving {tag}: server up with warmup in "
                  f"{time.perf_counter() - t_ready:.1f} s on port {srv.port}")
            bodies = [{"audio": s.audio.tolist(), "max_new_tokens": b}
                      for s, b in zip(aud_s, aud_b)]
            bodies.append({"audio": beam_sample.audio.tolist(), "max_new_tokens": 32,
                           "num_beams": 5})
            results, lat, errors = [None] * len(bodies), [0.0] * len(bodies), []

            def client(i):
                t0 = time.perf_counter()
                try:
                    results[i] = post(srv.port, bodies[i])
                except Exception as e:          # surfaced below
                    errors.append((i, repr(e)))
                lat[i] = time.perf_counter() - t0

            before = counts()
            t0 = time.perf_counter()
            threads = [threading.Thread(target=client, args=(i,)) for i in range(len(bodies))]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=900)
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
            by_path[tag] = since(before)
            check(not errors, f"{tag}: client errors {errors}")
            # a request that times out is cancelled: in the engine when it
            # was submitted (100 tokens take well over 0.5 s), or never
            # submitted when its client gave up first; either way it does
            # not decode to its end
            eng = srv.engine
            b_done, b_cancel, b_next = eng.requests_done, eng.requests_cancelled, eng._next_req
            try:
                post(srv.port, {"audio": aud_s[1].audio.tolist(), "max_new_tokens": 100,
                                "timeout_s": 0.5})
                check(False, f"{tag}: a 0.5 s timeout did not time out")
            except urllib.error.HTTPError as e:
                body = json.loads(e.read())
                check(e.code == 504 and body.get("cancelled") is True,
                      f"{tag}: timed-out request answered {e.code} {body}")
            # a request cancelled while staged is counted when its row is
            # swept at the next step (as in the JAX package); until then it
            # waits in the engine's cancelled set. The scheduler thread
            # updates these counters one after the other: poll them all.
            def settled() -> bool:
                n = eng._next_req - b_next
                return (eng.outstanding() == 0 and eng.requests_cancelled - b_cancel
                        + len(eng._cancelled) == n)

            deadline = time.time() + 120
            while not settled() and time.time() < deadline:
                time.sleep(0.05)
            check(eng.outstanding() == 0, f"{tag}: the cancelled request kept decoding")
            submitted = eng._next_req - b_next
            swept = eng.requests_cancelled - b_cancel
            check(eng.requests_done == b_done and swept + len(eng._cancelled) == submitted,
                  f"{tag}: timed-out request: submitted {submitted}, done "
                  f"{eng.requests_done - b_done}, cancelled {swept}, pending "
                  f"{len(eng._cancelled)}")
            g = lat[:half]
            out = dict(clients=half, beam_clients=1, wall_s=wall,
                       requests_per_s=len(bodies) / wall,
                       latency_p50_s=pct(g, 50), latency_p95_s=pct(g, 95),
                       beam_latency_s=lat[half], timed_out_request_cancelled=True,
                       timed_out_request_was_submitted=bool(submitted),
                       timed_out_request_swept=bool(swept),
                       engine_stats=srv.engine.stats(), launches=by_path[tag])
            out["_tokens"] = [r["tokens"] for r in results]
            out["_params"] = (params, c)
        finally:
            srv.stop()
        return out

    s32 = serve(["runtime.compute_dtype=float32"], "server_f32")
    params, c = s32.pop("_params")
    toks = s32.pop("_tokens")
    ref = static_batches(params, c, aud_s, aud_b, torch.float32)
    diff = [i for i in range(half) if toks[i] != ref["tokens"][i]]
    check(not diff, f"f32 server responses {diff} != generate_tokens")
    bb = featurize(collate([beam_sample], c.data, tok.encode(c.model.prompt, add_bos=True),
                           tok.pad_id), "cuda", torch.float32)
    bo = beam_search(params, c.model, bb, max_new_tokens=32, num_beams=5, eos_id=tok.eos_id,
                     compute_dtype=torch.float32)
    check(toks[half] == bo.tokens[0, : int(bo.lengths[0])].tolist(),
          "f32 server beam response != beam_search")
    s32.update(responses_equal_generate_tokens=True, beam_equals_beam_search=True)
    res["server_f32"] = s32
    print("serving server f32: " + json.dumps(s32))
    del params, c
    settle()
    s16 = serve([], "server_bf16")
    s16.pop("_params")
    s16.pop("_tokens")
    res["server_bf16"] = s16
    print("serving server bf16: " + json.dumps(s16))
    settle()

    for tag, n in by_path.items():
        check(n["flash_bwd_dq"] == n["flash_bwd_dkv"] == 0, f"{tag} launched a backward kernel")
        check(n["flash_fwd"] > 0, f"{tag} launched no flash forward")
    res["greedy_bf16_phase3"] = dict(ms_per_token=bf16["ms_per_token"],
                                     new_tokens_per_s=bf16["new_tokens_per_s"],
                                     peak_mem_gb=bf16["peak_mem_gb"])
    res["launches_by_path"] = by_path
    res["launches"] = {k: sum(p[k] for p in by_path.values()) for k in counts()}
    print("serving: launches " + json.dumps(by_path))
    return res


def _serving(st: dict, out, hb, launches: dict, phase: dict) -> dict:
    """Serving numbers of one generate_tokens call beside an earlier
    phase's."""
    B, steps = len(hb.utt_ids), st["decode_steps"]
    new = out.tokens.shape[1]
    return dict(encode_ms=st["encode_s"] * 1e3, prefill_ms=st["prefill_s"] * 1e3,
                ms_per_token=st["decode_s"] * 1e3 / steps,
                new_tokens_per_s=B * new / (st["encode_s"] + st["prefill_s"] + st["decode_s"]),
                launches=launches,
                random_init=dict(encode_ms=phase["encode_ms"], prefill_ms=phase["prefill_ms"],
                                 ms_per_token=phase["ms_per_token"],
                                 new_tokens_per_s=phase["new_tokens_per_s"]))


# ---------------------------------------------------------------------------
# Corpus phase
# ---------------------------------------------------------------------------

def wav_rate(path: str) -> int:
    import wave

    with wave.open(path) as w:
        return w.getframerate()


def link_bytes(hb) -> int:
    """The bytes of a host batch's media on the host->device link."""
    return sum(a.nbytes for a in (hb.audio, hb.frames, hb.frames_y, hb.frames_uv)
               if a is not None)


def make_corpus(base: Path, seed: int) -> Path:
    """48 utterances of 2-10 s as real files from ``seed`` (PCM16 WAVs, a
    quarter at 48 kHz; 96 x 96 frames at 25 per second as .npy; 2-7 word
    transcripts), split 24 / 12 / 12 by the prepare_data CLI's scan mode
    into ``base / "data"``."""
    from avsr_tpu_torch.cli import prepare_data

    corpus = base / "data"
    raw = prepare_data.make_demo(base / "raw", 48, seed + 1500, secs_range=(2.0, 10.0),
                                 rates=(48_000, 16_000, 16_000, 16_000), frame_size=96)
    check(prepare_data.main(["--data_dir", str(raw), "--transcripts",
                             str(raw / "transcripts.txt"),
                             "--out", str(corpus), "--splits", "0.5,0.25,0.25",
                             "--seed", str(seed)]) == 0, "prepare_data failed")
    sizes = {s: len((corpus / f"{s}.wrd").read_text().splitlines())
             for s in ("train", "valid", "test")}
    check(sizes == {"train": 24, "valid": 12, "test": 12}, f"split sizes {sizes}")
    return corpus


def corpus_phase(seed: int) -> dict:
    """Phase 15: a real-file corpus through every entry point at the
    flagship's full width (see the module docstring)."""
    import shutil
    from dataclasses import replace

    import torch

    from avsr_tpu_torch import native
    from avsr_tpu_torch.cli import common, decode, train
    from avsr_tpu_torch.core.config import flagship
    from avsr_tpu_torch.data.audio_io import load_audio
    from avsr_tpu_torch.data.loader import DataLoader, collate, featurize
    from avsr_tpu_torch.data.manifest import load_manifest
    from avsr_tpu_torch.infer.engine import ServingEngine
    from avsr_tpu_torch.infer.generate import generate_tokens, prepare_params_for_decode

    check(native.available(), "the native data library did not build on this host")
    base = ROOT / "outputs" / "chip_smoke" / time.strftime("corpus_%Y%m%d_%H%M%S")
    corpus, run, run_c = base / "data", base / "run", base / "run_compact"
    res: dict = {}
    by_path: dict[str, dict[str, int]] = {}
    data = ["data.synthetic=false", f"data.path={corpus}", "data.num_workers=4"]
    flag = ["--seed", str(seed), "--device", "cuda", *FLAGSHIP_OVERRIDES, *data]
    orig_iter = DataLoader.__iter__
    waits: list[float] = []

    def spy_iter(self):
        """The train loader's batches, timing how long the consumer waits
        for each one."""
        it = orig_iter(self)
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    return
                if self.shuffle:
                    waits.append(time.perf_counter() - t0)
                yield item
        finally:
            it.close()

    def counted(tag: str, fn):
        torch.cuda.synchronize()
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        by_path[tag] = counts()
        settle()
        return out

    def train_run(out: Path, steps: int, *extra: str) -> list[list[str]]:
        rc = train.main([*flag, "training.grad_accum_steps=1", f"training.max_steps={steps}",
                         "training.save_every_steps=0", f"training.checkpoint_dir={out}",
                         *extra])
        check(rc == 0, f"train CLI on the corpus returned {rc}")
        rows = loss_rows(out)
        train_rows = [r for r in rows if r[2] == "train"]
        check(len(train_rows) == steps and all(np.isfinite(float(r[3])) for r in train_rows),
              f"{out}: train rows {train_rows}")
        check([r[2] for r in rows].count("val") == 1, f"{out}: no validation row")
        return rows

    def decode_run(out: Path, *extra: str) -> list[str]:
        rc = decode.main([*flag, "decode.max_new_tokens=32", f"decode.output_dir={out}",
                          *extra, "--checkpoint", str(run / "ckpt"), "--split", "test"])
        check(rc == 0, f"decode CLI on the corpus returned {rc}")
        res_f, wer_f = list(out.glob("results_*.txt")), list(out.glob("wer_*.txt"))
        check(len(res_f) == 1 and len(wer_f) == 1, f"decode artifacts missing in {out}")
        text = res_f[0].read_text()
        check(text.count("UTT: ") == 12 and "utterances: 12\n" in wer_f[0].read_text(),
              f"{out}: the test split's 12 utterances were not each scored once")
        refs = sorted(ln[5:] for ln in text.splitlines() if ln.startswith("REF: "))
        check(refs == sorted((corpus / "test.wrd").read_text().splitlines()),
              f"{out}: references differ from test.wrd")
        m = re.search(r"WER: ([0-9.]+)", wer_f[0].read_text())
        check(m is not None and np.isfinite(float(m.group(1))), f"{out}: no WER")
        return [ln for ln in text.splitlines() if ln.startswith(("UTT: ", "HYP: "))]

    t_all = time.perf_counter()
    try:
        # 1. the corpus: real files, manifests by the prepare_data CLI's scan mode
        t0 = time.perf_counter()
        check(make_corpus(base, seed) == corpus, "corpus directory")
        sizes = {"train": 24, "valid": 12, "test": 12}
        res["corpus"] = dict(utterances=48, splits=sizes, write_and_scan_s=time.perf_counter() - t0,
                             mb_on_disk=sum(p.stat().st_size for p in base.rglob("*")
                                            if p.is_file()) / 1e6)

        # 2. training: one epoch of the train split (3 steps of 8), validation
        DataLoader.__iter__ = spy_iter
        try:
            rows = counted("manifest_train", lambda: train_run(run, 3))
        finally:
            DataLoader.__iter__ = orig_iter
        step_s = [float(r[7]) for r in rows if r[2] == "train"]
        res["train"] = dict(losses=[float(r[3]) for r in rows if r[2] == "train"],
                            val_loss=float(next(r[3] for r in rows if r[2] == "val")),
                            step_ms=[1e3 * s for s in step_s],
                            wait_ms=[1e3 * w for w in waits],
                            mean_wait_ms_after_first=1e3 * float(np.mean(waits[1:])))
        check(len(waits) == 3, f"the train loader handed out {len(waits)} batches, not 3")
        n = by_path["manifest_train"]
        check(n["flash_fwd"] > 0 and n["flash_bwd_dq"] > 0 and n["flash_bwd_dkv"] > 0,
              f"training on the corpus launches {n}")
        print("corpus train: " + json.dumps(res["train"]))

        # 3. decoding the test split from that checkpoint: bf16 and the preset
        hyp_bf16 = counted("manifest_decode_bf16", lambda: decode_run(base / "dec_bf16"))
        counted("manifest_decode_preset",
                lambda: decode_run(base / "dec_preset", *PRESET_OVERRIDES))
        n = by_path["manifest_decode_preset"]
        check(n["flash_fwd"] > 0 and n["qmatmul_int4"] > 0 and n["qmatmul_int8"] > 0,
              f"the preset decode on the corpus launches {n}")
        check(by_path["manifest_decode_bf16"]["flash_fwd"] > 0, "bf16 decode: no flash")

        # 4. the compact link: its first batch against the raw one on the
        # card, one train step and the bf16 decode
        def first_batch(compact: bool):
            cfg = flagship([*data, f"data.compact_transfer={str(compact).lower()}"])
            _, _, loader = common.build_data(cfg, "test", shuffle=False, device="cuda")
            hb = next(loader._host_batches())
            loader.close()
            return hb, featurize(hb, "cuda", torch.float32)

        (h_raw, b_raw), (h_c, b_c) = first_batch(False), first_batch(True)
        mel_d = (b_c.mel - b_raw.mel).abs().max().item()
        frame_d = (b_c.frames - b_raw.frames).abs().mean().item()
        check(h_c.audio.dtype == np.int16 and h_c.frames is None, "no compact host batch")
        check(mel_d <= 2e-2, f"compact mel max |d| {mel_d}")
        check(frame_d < 0.6, f"compact frames mean |d| {frame_d}")
        check(torch.equal(b_c.labels, b_raw.labels), "compact labels differ")
        counted("manifest_compact_train",
                lambda: train_run(run_c, 1, "data.compact_transfer=true"))
        shutil.rmtree(run_c / "ckpt", ignore_errors=True)
        hyp_c = counted("manifest_compact_decode",
                        lambda: decode_run(base / "dec_compact", "data.compact_transfer=true"))
        same = sum(a == b for a, b in zip(hyp_c, hyp_bf16) if a.startswith("HYP: "))
        res["compact"] = dict(mel_max_abs_diff=mel_d, frames_mean_abs_diff=frame_d,
                              link_bytes=link_bytes(h_c), raw_bytes=link_bytes(h_raw),
                              bf16_hyps_equal_raw_share=same / 12)
        print("corpus compact link: " + json.dumps(res["compact"]))

        # 5. the engine in f32 on the test split, straight from the manifest
        # dataset (WAV decode deferred), compact link on, budgets <= 32
        cfg32 = flagship(["runtime.compute_dtype=float32", *data,
                          "data.compact_transfer=true"])
        tok, ds, loader = common.build_data(cfg32, "test", shuffle=False, device="cuda")
        loader.close()
        samples = [ds[i] for i in range(len(ds))]
        check(ds.defer_audio and all(s.audio is None and s.audio_path for s in samples),
              "the test split's audio was not deferred")
        budgets = [int(b) for b in np.random.default_rng(seed + 1501).integers(8, 33, 12)]
        p32 = prepare_params_for_decode(common.init_or_load_params(cfg32, seed=seed,
                                                                   device="cuda"), cfg32.model)
        eng = ServingEngine(p32, cfg32, tok, num_slots=8, k_steps=16, seed=seed)
        run_e = counted("manifest_engine", lambda: drive_engine(eng, samples, budgets))
        check(by_path["manifest_engine"]["flash_fwd"] == 40 * eng.stages_run,
              f"engine launches {by_path['manifest_engine']}, stages {eng.stages_run}")
        eng.close()
        prompt = tok.encode(cfg32.model.prompt, add_bos=True)
        cap = cfg32.data.max_audio_length
        decoded = [replace(s, audio=load_audio(s.audio_path, max_samples=cap)) for s in samples]
        want = []
        for s in range(0, 12, 8):
            hb = collate(decoded[s:s + 8], cfg32.data, prompt, tok.pad_id)
            out = generate_tokens(p32, cfg32.model, featurize(hb, "cuda", torch.float32),
                                  max_new_tokens=max(budgets[s:s + 8]), eos_id=tok.eos_id,
                                  compute_dtype=torch.float32)
            want += [r[: min(n, b)] for r, n, b in zip(out.tokens.tolist(),
                                                       out.lengths.tolist(), budgets[s:s + 8])]
        diff = [i for i, (a, b) in enumerate(zip(run_e["tokens"], want)) if a != b]
        check(not diff, f"f32 engine on the corpus != generate_tokens for requests {diff}")
        res["engine_f32"] = dict(serving_numbers(run_e, eng=eng),
                                 tokens_equal_generate_tokens=True)
        del p32, eng
        settle()
        print("corpus engine f32: 12 requests equal generate_tokens token for token; "
              + json.dumps(res["engine_f32"]["stats"]))

        # 6. the loader's pace, on the host: prep per batch with 1 and 4
        # fetch threads, and the native batch decode against per-file Python
        pace = {}
        for workers in (1, 4):
            cfg = flagship([*data[:-1], f"data.num_workers={workers}"])
            _, _, loader = common.build_data(cfg, "train", shuffle=False, device="cuda")
            times, t0 = [], time.perf_counter()
            for _ in loader._host_batches():
                times.append(time.perf_counter() - t0)
                t0 = time.perf_counter()
            loader.close()
            pace[f"prep_ms_per_batch_workers_{workers}"] = [1e3 * t for t in times]
        root, entries = load_manifest(corpus / "train.tsv")
        paths = [str(root / e.audio_path) for e in entries]
        t0 = time.perf_counter()
        out, lens = native.decode_wav_batch(paths, max_samples=cap)
        pace["native_batch_decode_ms"] = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        py = [load_audio(p, max_samples=cap) for p in paths]
        pace["python_decode_ms"] = 1e3 * (time.perf_counter() - t0)
        check(all(abs(int(n) - len(a)) <= 4 for n, a in zip(lens, py)),
              "native and Python decodes differ in length")
        pace["native_vs_python_max_abs_diff"] = max(   # scipy's resampler for 48 kHz
            float(np.abs(out[i, :min(int(lens[i]), len(a))] - a[:int(lens[i])]).max())
            for i, a in enumerate(py))
        pace.update(files=len(paths), files_48khz=sum(
            wav_rate(p) == 48_000 for p in paths))
        res["loader_pace"] = pace
        print(f"corpus loader pace ({gpu_line()}): " + json.dumps(pace))
    finally:
        DataLoader.__iter__ = orig_iter
        shutil.rmtree(base, ignore_errors=True)
    check(not base.exists(), f"{base} not removed")
    res["launches_by_path"] = by_path
    res["seconds"] = time.perf_counter() - t_all
    print(f"corpus phase: {res['seconds']:.1f} s; launches " + json.dumps(by_path))
    return res


# ---------------------------------------------------------------------------
# Convert phase: HF and reference checkpoints, and the second shipped config
# ---------------------------------------------------------------------------

# torch dtypes -> safetensors dtype names
ST_DTYPES = {"float32": "F32", "float16": "F16", "bfloat16": "BF16", "int64": "I64"}


def write_safetensors(path: Path, tensors: dict) -> int:
    """One ``.safetensors`` file of CPU tensors in the public layout (an
    8-byte little-endian header length, the JSON header padded to 8 bytes,
    the raw bytes); returns its size. The card's host has no
    ``safetensors`` package."""
    import struct

    import torch

    header, off = {}, 0
    for k, t in tensors.items():
        n = t.numel() * t.element_size()
        header[k] = {"dtype": ST_DTYPES[str(t.dtype).split(".")[-1]],
                     "shape": list(t.shape), "data_offsets": [off, off + n]}
        off += n
    header["__metadata__"] = {"format": "pt"}
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in tensors.values():
            f.write(t.contiguous().reshape(-1).view(torch.uint8).numpy().data)
    return 8 + len(raw) + off


def _hf_ln(name: str, p: dict) -> dict:
    return {f"{name}.weight": p["scale"], f"{name}.bias": p["b"]}


def _hf_lin(name: str, p: dict) -> dict:
    out = {f"{name}.weight": p["w"].T}
    if "b" in p:
        out[f"{name}.bias"] = p["b"]
    return out


def hf_speech_ssl_state(p: dict) -> dict:
    """A HuBERT/Wav2Vec2 tree of the port -> ``HubertModel`` keys, with the
    positional conv's weight norm under its legacy names (g = ||w|| per
    kernel tap, v = w, so that g * v / ||v|| gives w back within f32
    rounding)."""
    import torch

    sd = {}
    for i, c in enumerate(p["fe"]):
        pre = f"feature_extractor.conv_layers.{i}."
        sd[pre + "conv.weight"] = c["w"]
        if "b" in c:
            sd[pre + "conv.bias"] = c["b"]
        if "norm" in c:
            sd.update(_hf_ln(pre + "layer_norm", c["norm"]))
    sd.update(_hf_ln("feature_projection.layer_norm", p["proj_ln"]))
    sd.update(_hf_lin("feature_projection.projection", p["proj"]))
    w = p["pos_conv"]["w"]
    sd["encoder.pos_conv_embed.conv.weight_g"] = (
        w.double().square().sum(dim=(0, 1), keepdim=True).sqrt().to(w.dtype))
    sd["encoder.pos_conv_embed.conv.weight_v"] = w
    sd["encoder.pos_conv_embed.conv.bias"] = p["pos_conv"]["b"]
    sd.update(_hf_ln("encoder.layer_norm", p["ln"]))
    for i, b in enumerate(p["blocks"]):
        pre = f"encoder.layers.{i}."
        for ours, hf in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("o", "out_proj")):
            sd.update(_hf_lin(pre + "attention." + hf, b["attn"][ours]))
        sd.update(_hf_ln(pre + "layer_norm", b["ln1"]))
        sd.update(_hf_lin(pre + "feed_forward.intermediate_dense", b["fc1"]))
        sd.update(_hf_lin(pre + "feed_forward.output_dense", b["fc2"]))
        sd.update(_hf_ln(pre + "final_layer_norm", b["ln2"]))
    sd["masked_spec_embed"] = torch.zeros_like(p["proj"]["b"])
    return sd


def hf_llama_state(p: dict, prefix: str = "model.") -> dict:
    """A Llama tree of the port -> ``LlamaForCausalLM`` keys (a tied head:
    no ``lm_head.weight``)."""
    sd = {prefix + "embed_tokens.weight": p["embed"]}
    names = {"q": "self_attn.q_proj", "k": "self_attn.k_proj", "v": "self_attn.v_proj",
             "o": "self_attn.o_proj", "gate": "mlp.gate_proj", "up": "mlp.up_proj",
             "down": "mlp.down_proj"}
    for i, layer in enumerate(p["layers"]):
        pre = f"{prefix}layers.{i}."
        sd[pre + "input_layernorm.weight"] = layer["ln_attn"]["scale"]
        sd[pre + "post_attention_layernorm.weight"] = layer["ln_mlp"]["scale"]
        for ours, hf in names.items():
            sd[f"{pre}{hf}.weight"] = layer[ours]["w"].T
    sd[prefix + "norm.weight"] = p["ln_f"]["scale"]
    return sd


def hf_whisper_state(p: dict) -> dict:
    """A Whisper encoder tree of the port -> ``WhisperForConditionalGeneration``
    keys (``model.encoder.*``; k_proj has no bias)."""
    pre = "model.encoder."
    sd = {pre + "conv1.weight": p["conv1"]["w"], pre + "conv1.bias": p["conv1"]["b"],
          pre + "conv2.weight": p["conv2"]["w"], pre + "conv2.bias": p["conv2"]["b"],
          pre + "embed_positions.weight": p["pos"]}
    for i, b in enumerate(p["blocks"]):
        lp = f"{pre}layers.{i}."
        for ours, hf in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("o", "out_proj")):
            sd.update(_hf_lin(lp + "self_attn." + hf, b["attn"][ours]))
        sd.update(_hf_ln(lp + "self_attn_layer_norm", b["ln1"]))
        sd.update(_hf_lin(lp + "fc1", b["fc1"]))
        sd.update(_hf_lin(lp + "fc2", b["fc2"]))
        sd.update(_hf_ln(lp + "final_layer_norm", b["ln2"]))
    sd.update(_hf_ln(pre + "layer_norm", p["ln_post"]))
    return sd


def hf_clip_state(p: dict, patch: int) -> dict:
    """A CLIP ViT tree of the port -> ``vision_model.*`` keys (the layout of
    ``CLIPVisionModel``, and of ``CLIPModel``'s vision tower)."""
    pre = "vision_model."
    d = p["cls"].shape[0]
    sd = {pre + "embeddings.class_embedding": p["cls"],
          pre + "embeddings.patch_embedding.weight": p["patch"]["w"].T.reshape(d, 3, patch,
                                                                              patch),
          pre + "embeddings.position_embedding.weight": p["pos"]}
    sd.update(_hf_ln(pre + "pre_layrnorm", p["ln_pre"]))
    for i, b in enumerate(p["blocks"]):
        lp = f"{pre}encoder.layers.{i}."
        for ours, hf in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("o", "out_proj")):
            sd.update(_hf_lin(lp + "self_attn." + hf, b["attn"][ours]))
        sd.update(_hf_ln(lp + "layer_norm1", b["ln1"]))
        sd.update(_hf_lin(lp + "mlp.fc1", b["fc1"]))
        sd.update(_hf_lin(lp + "mlp.fc2", b["fc2"]))
        sd.update(_hf_ln(lp + "layer_norm2", b["ln2"]))
    sd.update(_hf_ln(pre + "post_layernorm", p["ln_post"]))
    return sd


def hf_configs(mc) -> dict[str, dict]:
    """config.json of each directory, from the port's model config."""
    s, w, c, lm = mc.ssl, mc.whisper, mc.clip, mc.llm
    return {
        "hubert": dict(
            model_type="hubert", architectures=["HubertModel"], hidden_size=s.d_model,
            num_hidden_layers=s.n_layers, num_attention_heads=s.n_heads,
            intermediate_size=s.d_model * s.ffn_mult, conv_dim=list(s.conv_dims),
            conv_kernel=list(s.conv_kernels), conv_stride=list(s.conv_strides),
            conv_bias=s.conv_bias, feat_extract_norm=s.feat_extract_norm,
            do_stable_layer_norm=s.do_stable_layer_norm,
            num_conv_pos_embeddings=s.pos_conv_kernel,
            num_conv_pos_embedding_groups=s.pos_conv_groups,
            num_feat_extract_layers=len(s.conv_dims), torch_dtype="float32"),
        "llm": dict(
            model_type="llama", architectures=["LlamaForCausalLM"], hidden_size=lm.d_model,
            intermediate_size=lm.ffn_dim, num_hidden_layers=lm.n_layers,
            num_attention_heads=lm.n_heads, num_key_value_heads=lm.n_kv_heads,
            vocab_size=lm.vocab_size, rope_theta=lm.rope_theta, rms_norm_eps=lm.rms_eps,
            tie_word_embeddings=True, torch_dtype="bfloat16"),
        "whisper": dict(
            model_type="whisper", architectures=["WhisperForConditionalGeneration"],
            d_model=w.d_model, encoder_layers=w.n_layers, encoder_attention_heads=w.n_heads,
            encoder_ffn_dim=w.d_model * w.ffn_mult, decoder_layers=w.n_layers,
            decoder_attention_heads=w.n_heads, decoder_ffn_dim=w.d_model * w.ffn_mult,
            num_mel_bins=w.n_mels, max_source_positions=w.max_source_positions,
            torch_dtype="float32"),
        "clip": dict(
            model_type="clip_vision_model", architectures=["CLIPVisionModel"],
            hidden_size=c.d_model, intermediate_size=c.d_model * c.ffn_mult,
            num_hidden_layers=c.n_layers, num_attention_heads=c.n_heads,
            image_size=c.image_size, patch_size=c.patch_size, torch_dtype="float32"),
    }


def write_hf_checkpoints(root: Path, trees: dict, mc) -> dict[str, int]:
    """HF-layout directories of the port trees in ``trees`` (any of
    "hubert", "llm", "whisper", "clip"), each with its config.json:
    HuBERT as one ``model.safetensors`` (f32, legacy weight norm), the Llama
    in its own dtype split into two safetensors shards plus the index, the
    Whisper encoder as a ``pytorch_model.bin``, CLIP as one
    ``model.safetensors``. Returns the bytes written per directory."""
    import torch

    cfgs = hf_configs(mc)
    sizes = {}
    for name, tree in trees.items():
        d = root / name
        d.mkdir(parents=True)
        sd = {"hubert": hf_speech_ssl_state, "llm": hf_llama_state,
              "whisper": hf_whisper_state,
              "clip": lambda p: hf_clip_state(p, mc.clip.patch_size)}[name](tree)
        sd = {k: v.detach().contiguous().cpu() for k, v in sd.items()}
        (d / "config.json").write_text(json.dumps(cfgs[name], indent=1))
        if name == "whisper":
            torch.save(sd, d / "pytorch_model.bin")
        elif name == "llm":
            keys, half, acc, shards = list(sd), sum(t.nbytes for t in sd.values()) / 2, 0, [[]]
            for k in keys:
                if acc >= half and len(shards) == 1:
                    shards.append([])
                shards[-1].append(k)
                acc += sd[k].nbytes
            files = [f"model-0000{i + 1}-of-00002.safetensors" for i in range(2)]
            for f, ks in zip(files, shards):
                write_safetensors(d / f, {k: sd[k] for k in ks})
            (d / "model.safetensors.index.json").write_text(json.dumps(
                {"metadata": {"total_size": int(2 * half)},
                 "weight_map": {k: f for f, ks in zip(files, shards) for k in ks}}))
        else:
            write_safetensors(d / "model.safetensors", sd)
        sizes[name] = sum(f.stat().st_size for f in d.iterdir())
    return sizes


def jitter(tree, gen, std: float = 0.02):
    """Random weights from ``gen`` on every float leaf of a fresh init (its
    norms and biases are ones and zeros), in place."""
    import torch

    def walk(node):
        if isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)
        elif node.is_floating_point():
            node.add_(std * torch.randn(node.shape, generator=gen, device=node.device,
                                        dtype=node.dtype))

    walk(tree)
    return tree


def hubert_kernel_row(seed: int) -> dict:
    """The attention kernels at HuBERT-base's shape on 10 s of audio (B = 8,
    12 heads, 499 valid frames padded to 512 rows, non-causal), in each
    form the ``hubert_base`` paths launch them: the bf16 forward (decode,
    serving, training), the f32 forward (the f32 export, engine and
    streaming checks) and the bf16 dQ and dK/dV (the train step with
    ``unfreeze_layer_norms``). Each is held to its plain version at 499
    rows, on a ragged set and at 30 s (1499 frames in 1504 rows); the bf16
    ones are then timed as the kernel phases time the other shapes."""
    return ssl_kernel_row(seed + 1612, "hubert", (512, 499),
                          (499, 311, 260, 499, 17, 400, 256, 1), (1504, 1499, "30s"))


def ssl_kernel_row(seed: int, tag: str, main: tuple[int, int], ragged: tuple[int, ...],
                   long: tuple[int, int, str]) -> dict:
    """The attention kernels of a 12-head SSL transformer (B = 8, head width
    64, non-causal) at ``main`` = (rows, valid rows): the bf16 and f32
    forward and the bf16 dQ and dK/dV held to their plain versions there,
    on the ``ragged`` lengths and at ``long`` = (rows, valid rows, name);
    the bf16 ones timed at ``main``."""
    import torch

    from avsr_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def qkv(T: int):
        return [torch.randn((8, 12, T, 64), generator=gen, device="cuda",
                            dtype=torch.bfloat16) for _ in range(4)]

    def lengths(*n: int):
        return torch.tensor(n if len(n) == 8 else n * 8, dtype=torch.int32, device="cuda")

    q, k, v, do = qkv(main[0])
    lens = lengths(main[1])
    cases = (("main", (q, k, v, do), lens),
             ("ragged", (q, k, v, do), lengths(*ragged)),
             (long[2], qkv(long[0]), lengths(long[1])))
    err = lse_max = err32 = lse32 = 0.0
    bwd_err = {"dq": 0.0, "dk": 0.0, "dv": 0.0}
    for case, (q_, k_, v_, do_), ln in cases:
        o, lse = A.flash_attention(q_, k_, v_, ln, ln, False)
        o_r, lse_r = A.flash_attention_reference(q_, k_, v_, ln, ln, False)
        torch.cuda.synchronize()
        e = (o.float() - o_r.float()).abs()
        check(bool((e <= 2e-2 + 2e-2 * o_r.float().abs()).all()),
              f"{tag}/{case}: O off by {e.max().item():.3e} (atol=rtol=2e-2)")
        fin = torch.isfinite(lse_r)
        check(torch.equal(fin, torch.isfinite(lse)), f"{tag}/{case}: lse +inf rows differ")
        lse_err = (lse[fin] - lse_r[fin]).abs().max().item()
        check(lse_err <= 1e-3, f"{tag}/{case}: lse off by {lse_err:.3e} (atol 1e-3)")
        n = int(ln.min())
        check(bool((o[ln == n][:, :, n:] == 0).all()), f"{tag}/{case}: padded rows not zero")
        err, lse_max = max(err, e.max().item()), max(lse_max, lse_err)

        # dQ and dK/dV, dQ handing its delta on, as the train step runs them
        dq, delta = A.flash_bwd_dq(q_, k_, v_, o, lse, do_, ln, ln, False)
        dk, dv = A.flash_bwd_dkv(q_, k_, v_, lse, delta, do_, ln, ln, False)
        refs = A.flash_attention_bwd_reference(q_, k_, v_, o, lse, do_, ln, ln, False)
        delta_r = A.flash_bwd_dq_reference(q_, k_, v_, o, lse, do_, ln, ln, False)[1]
        torch.cuda.synchronize()
        d_err = (delta - delta_r).abs().max().item()
        check(d_err <= 1e-4 * max(1.0, delta_r.abs().max().item()),
              f"{tag}/{case}: delta off by {d_err:.3e}")
        for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
            check(bool(torch.isfinite(got.float()).all()), f"{tag}/{case}: {name} not finite")
            r = rel_err(got, ref)
            check(r <= 2e-2, f"{tag}/{case}: {name} max|d| {r:.3e} x max|ref| > 2e-2")
            bwd_err[name] = max(bwd_err[name], r)
        del dq, delta, dk, dv, refs, delta_r

        # the f32 forward, at the f32 edge cases' tolerance
        q32, k32, v32 = (t.float() for t in (q_, k_, v_))
        o, lse = A.flash_attention(q32, k32, v32, ln, ln, False)
        o_r, lse_r = A.flash_attention_reference(q32, k32, v32, ln, ln, False)
        torch.cuda.synchronize()
        e32 = (o - o_r).abs().max().item()
        check(torch.equal(fin, torch.isfinite(lse)), f"{tag}/{case}: f32 lse +inf rows differ")
        l32 = (lse[fin] - lse_r[fin]).abs().max().item()
        check(e32 <= 1e-4 and l32 <= 1e-4,
              f"{tag}/{case}: f32 O off by {e32:.3e}, lse by {l32:.3e} (atol 1e-4)")
        check(bool((o[ln == n][:, :, n:] == 0).all()),
              f"{tag}/{case}: f32 padded rows not zero")
        err32, lse32 = max(err32, e32), max(lse32, l32)
        del o, lse, o_r, lse_r, q32, k32, v32
    print(f"kernel {tag}: bf16 forward, f32 forward and dQ/dK/dV held to their plain "
          f"versions (main, ragged, {long[2]}): max|dO| {err:.3e}, f32 max|dO| {err32:.3e}, "
          "max|d|/max|ref| " + ", ".join(f"{n_} {e_:.3e}" for n_, e_ in bwd_err.items()))

    ms = graph_ms([lambda: A.flash_attention(q, k, v, lens, lens, False)])
    plain_ms = time_ms(lambda: A.flash_attention_reference(q, k, v, lens, lens, False), 5)
    lib = sdpa_ms(q, k, v, lens, False)
    bounds = attn_bounds(q, k, lens, lens, False)
    ops_ms, bytes_ms = bounds["fwd"]
    row = dict(shape=tag, q=list(q.shape), kv=list(k.shape), causal=False, lens=main[1],
               max_abs_err=err, max_lse_err=lse_max, ms=ms, plain_ms=plain_ms,
               library_ms=lib["ms"], library=lib, bound_ms=max(ops_ms, bytes_ms),
               bound_by="operations" if ops_ms >= bytes_ms else "bytes",
               ops_ms=ops_ms, bytes_ms=bytes_ms,
               f32=dict(max_abs_err=err32, max_lse_err=lse32))
    print(f"kernel {tag} ({gpu_line()}): {ms:.4f} ms (plain {plain_ms:.4f}, SDPA "
          f"{lib['ms']:.4f} [{lib['call']}], bound {row['bound_ms']:.4f} by "
          f"{row['bound_by']}), max|dO| {err:.3e}")

    o, lse = A.flash_attention(q, k, v, lens, lens, False)
    args_dq = (q, k, v, o, lse, do, lens, lens, False)
    _, delta = A.flash_bwd_dq(*args_dq)
    args_dkv = (q, k, v, lse, delta, do, lens, lens, False)
    times = {"dq": graph_ms([lambda: A.flash_bwd_dq(*args_dq)]),
             "dkv": graph_ms([lambda: A.flash_bwd_dkv(*args_dkv)])}
    plain = {"dq": time_ms(lambda: A.flash_bwd_dq_reference(*args_dq), 3),
             "dkv": time_ms(lambda: A.flash_bwd_dkv_reference(*args_dkv), 3)}
    lib_bwd = sdpa_ms(q, k, v, lens, False, do)
    bwd = dict(max_rel_err=bwd_err, library_bwd_pair=lib_bwd)
    for name in ("dq", "dkv"):
        ops_ms, bytes_ms = bounds[name]
        bwd[name] = dict(ms=times[name], plain_ms=plain[name],
                         bound_ms=max(ops_ms, bytes_ms), ops_ms=ops_ms, bytes_ms=bytes_ms,
                         bound_by="operations" if ops_ms >= bytes_ms else "bytes")
    row["bwd"] = bwd
    print(f"kernel {tag} bwd ({gpu_line()}): dQ {times['dq']:.4f} ms (plain "
          f"{plain['dq']:.4f}, bound {bwd['dq']['bound_ms']:.4f}), dK/dV "
          f"{times['dkv']:.4f} ms (plain {plain['dkv']:.4f}, bound "
          f"{bwd['dkv']['bound_ms']:.4f}), SDPA backward {lib_bwd['ms']:.4f} ms")
    return row


def convert_phase(seed: int) -> dict:
    """Phase 16: HF and reference-trainer checkpoints converted at full
    width, and ``hubert_base`` trained, decoded, served and streamed from
    its export (see the module docstring)."""
    import shutil
    from dataclasses import replace

    import torch

    from avsr_tpu_torch.cli import common, convert_hf, convert_ref_ckpt, decode, train
    from avsr_tpu_torch.core.config import flagship, hubert_base, save_config
    from avsr_tpu_torch.data.audio_io import load_audio
    from avsr_tpu_torch.data.dataset import Sample
    from avsr_tpu_torch.data.loader import collate, featurize
    from avsr_tpu_torch.data.tokenizer import ByteTokenizer
    from avsr_tpu_torch.infer.engine import ServingEngine
    from avsr_tpu_torch.infer.generate import generate_tokens, prepare_params_for_decode
    from avsr_tpu_torch.infer.streaming import StreamingTranscriber
    from avsr_tpu_torch.models.clip_vit import init_clip_vit
    from avsr_tpu_torch.models.hubert import init_speech_ssl, speech_ssl_apply
    from avsr_tpu_torch.models.llama import init_llama
    from avsr_tpu_torch.models.whisper_encoder import init_whisper_encoder
    from avsr_tpu_torch.train import loop
    from avsr_tpu_torch.train.checkpoint import load_params
    from avsr_tpu_torch.train.state import path_leaves

    base = ROOT / "outputs" / "chip_smoke" / time.strftime("convert_%Y%m%d_%H%M%S")
    hf, run = base / "hf", base / "run"
    res: dict = {}
    by_path: dict[str, dict[str, int]] = {}
    # full width at MESH_DEPTH: the writes, reads and checkpoints of a
    # quarter of the blocks (HuBERT's 12 whole), every leaf kind still
    fl, hcfg = flagship(list(MESH_DEPTH)), hubert_base(list(MESH_DEPTH))
    nH, nL, nW = hcfg.model.ssl.n_layers, hcfg.model.llm.n_layers, fl.model.whisper.n_layers

    def counted(tag: str, fn):
        torch.cuda.synchronize()
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        by_path[tag] = counts()
        settle()
        return out

    def want(flash=0, dq=0, dkv=0, int8=0, int4=0) -> dict[str, int]:
        return dict(flash_fwd=flash, flash_bwd_dq=dq, flash_bwd_dkv=dkv, qmatmul_int8=int8,
                    qmatmul_int4=int4)

    def gb(path: Path) -> float:
        return sum(f.stat().st_size for f in path.rglob("*") if f.is_file()) / 1e9

    def same(tag: str, got: dict, ref: dict, approx=()) -> int:
        """Every leaf of ``ref`` (a tree's path_leaves) equal to ``got``'s
        in f32, bit for bit; the paths in ``approx`` within f32 rounding."""
        for k, r in ref.items():
            g = got[k].to("cuda", torch.float32)
            r = r.to("cuda", torch.float32)
            check(g.shape == r.shape, f"{tag}: {k} has shape {tuple(g.shape)}")
            if k in approx:
                rel = ((g - r).abs().max() / r.abs().max()).item()
                check(rel <= 1e-5, f"{tag}: {k} off by {rel:.3e} of max|w| (1e-5)")
            else:
                check(torch.equal(g, r), f"{tag}: {k} differs from the written weight")
        return len(ref)

    t_all = time.perf_counter()
    try:
        # 1. random full-width weights from the seed, written as HF directories
        gen = torch.Generator(device="cuda").manual_seed(seed + 1600)
        trees = {"hubert": jitter(init_speech_ssl(gen, hcfg.model.ssl), gen),
                 "llm": jitter(init_llama(gen, fl.model.llm, torch.bfloat16), gen),
                 "whisper": jitter(init_whisper_encoder(gen, fl.model.whisper), gen),
                 "clip": jitter(init_clip_vit(gen, fl.model.clip), gen)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        written = write_hf_checkpoints(hf, trees, fl.model)
        res["hf_write"] = dict(gb={k: v / 1e9 for k, v in written.items()},
                               seconds=time.perf_counter() - t0)
        print(f"convert: HF directories written ({gpu_line()}): " + json.dumps(res["hf_write"]))

        # 2. convert both shipped configs through the CLI
        hub_json = base / "hubert_base.json"
        save_config(hcfg, hub_json)
        convs = {
            "base": [*FLAGSHIP_OVERRIDES, *MESH_DEPTH,
                     f"model.whisper_path={hf / 'whisper'}", f"model.clip_path={hf / 'clip'}",
                     f"model.llm_path={hf / 'llm'}"],
            "hubert_base": ["--config", str(hub_json),
                            f"model.audio_encoder_path={hf / 'hubert'}",
                            f"model.llm_path={hf / 'llm'}"],
        }
        reads = {"base": ("whisper", "clip", "llm"), "hubert_base": ("hubert", "llm")}
        res["convert"] = {}
        for name, args in convs.items():
            out = base / f"export_{name}"
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            check(convert_hf.main(["--device", "cuda", "--out", str(out), *args]) == 0,
                  f"convert_hf {name} failed")
            secs = time.perf_counter() - t0
            exp = path_leaves(load_params(out))
            n = 0
            for comp in reads[name]:
                ref = path_leaves({comp: trees[comp]})
                n += same(f"{name}/{comp}", exp, ref, approx=("hubert/pos_conv/w",))
            lora_b = [v for k, v in exp.items() if k.endswith("/lora/b")]
            check(len(lora_b) == 4 * nL and all(not v.any() for v in lora_b),
                  f"{name}: the fresh LoRA b leaves are not zero")
            check(all(v.dtype == torch.float32 for v in exp.values()),
                  f"{name}: the export is not all float32")
            read_gb = sum(written[c] for c in reads[name]) / 1e9
            res["convert"][name] = dict(seconds=secs, gb_read=read_gb, gb_written=gb(out),
                                        leaves_equal=n, s_per_gb_read=secs / read_gb)
            print(f"convert {name}: {n} converted leaves equal the written weights; "
                  + json.dumps(res["convert"][name]))
            del exp
            settle()
        shutil.rmtree(base / "export_base")
        hub_export = base / "export_hubert_base"
        del trees
        settle()

        # 3. hubert_base on the corpus: 3 LoRA steps from the export, 1 with
        # unfreeze_layer_norms, then the test split decoded in bf16 and the preset
        corpus = make_corpus(base, seed)
        data = ["data.synthetic=false", f"data.path={corpus}", "data.num_workers=4"]
        hflag = ["--config", str(hub_json), "--seed", str(seed), "--device", "cuda", *data]

        def train_run(out: Path, steps: int, *extra: str) -> list[float]:
            rc = train.main([*hflag, "training.grad_accum_steps=1",
                             f"training.max_steps={steps}", "training.save_every_steps=0",
                             f"training.checkpoint_dir={out}", *extra,
                             "--checkpoint", str(hub_export)])
            check(rc == 0, f"train CLI (hubert_base) returned {rc}")
            rows = loss_rows(out)
            tr = [r for r in rows if r[2] == "train"]
            check(len(tr) == steps and all(np.isfinite(float(r[3])) for r in tr),
                  f"{out}: train rows {tr}")
            check([r[2] for r in rows].count("val") == 1, f"{out}: no validation row")
            return [1e3 * float(r[7]) for r in tr]

        peaks: list[float] = []
        make_step = loop.make_train_step

        def peak_step(*args):
            """The train step with its peak memory read per call."""
            step = make_step(*args)

            def run_step(*a, **k):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                out = step(*a, **k)
                torch.cuda.synchronize()
                peaks.append(torch.cuda.max_memory_allocated() / 1e9)
                return out
            return run_step

        loop.make_train_step = peak_step
        try:
            step_ms = counted("hubert_train", lambda: train_run(run, 3))
        finally:
            loop.make_train_step = make_step
        res["train"] = dict(step_ms=step_ms, step_peak_mem_gb=peaks)
        # per step of 8: 12 HuBERT blocks without grad, 16 LLM blocks and their
        # recompute; each validation batch (12 utterances: 2) 12 + 16
        w = want(flash=3 * (nH + 2 * nL) + 2 * (nH + nL), dq=3 * nL, dkv=3 * nL)
        check(by_path["hubert_train"] == w,
              f"hubert_base train launches {by_path['hubert_train']}, expected {w}")
        step_ln = counted("hubert_train_unfreeze_ln", lambda: train_run(
            base / "run_ln", 1, "model.unfreeze_layer_norms=true"))
        # the encoder now runs with grad and remat: its blocks are recomputed and
        # their backward launches dQ and dK/dV at the HuBERT shape
        w = want(flash=2 * (nH + nL) + 2 * (nH + nL), dq=nH + nL, dkv=nH + nL)
        check(by_path["hubert_train_unfreeze_ln"] == w,
              f"unfreeze_layer_norms launches {by_path['hubert_train_unfreeze_ln']}, "
              f"expected {w}")
        res["train_unfreeze_layer_norms"] = dict(step_ms=step_ln)
        print("convert hubert_base train: " + json.dumps(res["train"]) + "; unfreeze_ln "
              + json.dumps(step_ln))
        shutil.rmtree(base / "run_ln", ignore_errors=True)

        def decode_run(out: Path, *extra: str) -> list[str]:
            rc = decode.main([*hflag, "decode.max_new_tokens=32", f"decode.output_dir={out}",
                              *extra, "--checkpoint", str(run / "ckpt"), "--split", "test"])
            check(rc == 0, f"decode CLI (hubert_base) returned {rc}")
            (res_f,), (wer_f,) = out.glob("results_*.txt"), out.glob("wer_*.txt")
            text = res_f.read_text()
            check(text.count("UTT: ") == 12 and "utterances: 12\n" in wer_f.read_text(),
                  f"{out}: the test split's 12 utterances were not each scored once")
            refs = sorted(ln[5:] for ln in text.splitlines() if ln.startswith("REF: "))
            check(refs == sorted((corpus / "test.wrd").read_text().splitlines()),
                  f"{out}: references differ from test.wrd")
            return [ln for ln in text.splitlines() if ln.startswith("HYP: ")]

        counted("hubert_decode_bf16", lambda: decode_run(base / "dec_bf16"))
        check(by_path["hubert_decode_bf16"] == want(flash=2 * (nH + nL)),
              f"bf16 decode launches {by_path['hubert_decode_bf16']}")
        counted("hubert_decode_preset", lambda: decode_run(base / "dec_preset",
                                                           *PRESET_OVERRIDES))
        n = by_path["hubert_decode_preset"]
        # per decode step 16 layers x 4 int4 projections and the int8 head;
        # one more head per batch at the prefill's last position
        steps = n["qmatmul_int4"] // (4 * nL)
        check(steps > 0 and n == want(flash=2 * (nH + nL), int4=4 * nL * steps,
                                      int8=steps + 2),
              f"preset decode launches {n}")
        res["decode_preset_steps"] = steps

        # one static serving call in bf16 from the export, as phase 3's:
        # 8 test utterances in the 10 s bucket, 100 greedy tokens
        p16 = common.load_decode_params(hcfg, str(hub_export), seed=seed, device="cuda")
        _, _, loader = common.build_data(hubert_base(data), "test", shuffle=False,
                                         device="cuda")
        _, b16 = next(iter(loader))
        loader.close()
        kw16 = dict(max_new_tokens=100, eos_id=-1, compute_dtype=torch.bfloat16)
        generate_tokens(p16, hcfg.model, b16, **{**kw16, "max_new_tokens": 4})  # warm-up
        # HuBERT's own launches: one encoder call on the 10 s batch
        with torch.no_grad():
            counted("hubert_encoder_bf16", lambda: speech_ssl_apply(
                p16[hcfg.model.audio_encoder], b16.wave, hcfg.model.ssl,
                wave_lengths=b16.wave_lens, compute_dtype=torch.bfloat16))
        check(by_path["hubert_encoder_bf16"] == want(flash=nH),
              f"HuBERT encoder launches {by_path['hubert_encoder_bf16']}, expected {nH}")
        torch.cuda.reset_peak_memory_stats()
        st16: dict = {}
        counted("hubert_generate_bf16", lambda: generate_tokens(p16, hcfg.model, b16,
                                                                stats=st16, **kw16))
        check(by_path["hubert_generate_bf16"] == want(flash=nH + nL),
              f"bf16 generate launches {by_path['hubert_generate_bf16']}")
        check(bool(torch.isfinite(st16["prefill_logits"]).all()), "bf16 prefill logits")
        n_steps = st16["decode_steps"]
        res["serve_bf16"] = dict(
            encode_ms=st16["encode_s"] * 1e3, prefill_ms=st16["prefill_s"] * 1e3,
            ms_per_token=st16["decode_s"] * 1e3 / n_steps,
            new_tokens_per_s=8 * 100 / (st16["encode_s"] + st16["prefill_s"]
                                        + st16["decode_s"]),
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
            wave=list(b16.wave.shape))
        print(f"convert hubert_base bf16 serving call ({gpu_line()}): "
              + json.dumps(res["serve_bf16"]))
        del p16, b16
        settle()

        # 4. f32: the export against the in-memory conversion, the engine and
        # exact streaming against generate_tokens
        over32 = ["runtime.compute_dtype=float32", "data.compact_transfer=true", *data,
                  *MESH_DEPTH]
        cfg32 = hubert_base(over32)
        mem_cfg = hubert_base([*over32, f"model.audio_encoder_path={hf / 'hubert'}",
                               f"model.llm_path={hf / 'llm'}"])
        tok = ByteTokenizer()
        p_exp = prepare_params_for_decode(common.init_or_load_params(
            cfg32, str(hub_export), seed=seed, device="cuda"), cfg32.model)
        mem, _ = convert_hf.build_converted_params(mem_cfg, device="cuda")
        p_mem = prepare_params_for_decode(mem, cfg32.model)
        del mem
        _, ds, loader = common.build_data(cfg32, "test", shuffle=False, device="cuda")
        hb, batch = next(iter(loader))
        loader.close()
        check(batch.wave is not None and batch.mel is None and batch.wave.shape[1] == 160_000,
              f"the wave front end: {None if batch.wave is None else tuple(batch.wave.shape)}")
        kw = dict(max_new_tokens=32, eos_id=tok.eos_id, compute_dtype=torch.float32)
        out_exp = counted("hubert_generate_f32", lambda: generate_tokens(
            p_exp, cfg32.model, batch, **kw))
        out_mem = generate_tokens(p_mem, cfg32.model, batch, **kw)
        check(torch.equal(out_exp.tokens, out_mem.tokens)
              and torch.equal(out_exp.lengths, out_mem.lengths),
              "f32 generate_tokens from the export != from the in-memory conversion")
        check(by_path["hubert_generate_f32"] == want(flash=nH + nL),
              f"f32 generate launches {by_path['hubert_generate_f32']}")
        del p_mem
        settle()

        # the engine admits the split straight from the manifest dataset (its
        # WAV decode deferred) over the compact link
        deferred = [ds[i] for i in range(len(ds))]
        check(all(s.audio is None and s.audio_path for s in deferred),
              "the test split's audio was not deferred")
        samples = [replace(s, audio=load_audio(s.audio_path,
                                               max_samples=cfg32.data.max_audio_length))
                   for s in deferred]
        budgets = [int(b) for b in np.random.default_rng(seed + 1601).integers(8, 33, 12)]
        eng = ServingEngine(p_exp, cfg32, tok, num_slots=8, k_steps=16, seed=seed)
        run_e = counted("hubert_engine_f32", lambda: drive_engine(eng, deferred, budgets))
        check(by_path["hubert_engine_f32"] == want(flash=(nH + nL) * eng.stages_run),
              f"engine launches {by_path['hubert_engine_f32']}, stages {eng.stages_run}")
        eng.close()
        prompt = tok.encode(cfg32.model.prompt, add_bos=True)
        ref = []
        for s in range(0, 12, 8):
            b = featurize(collate(samples[s:s + 8], cfg32.data, prompt, tok.pad_id), "cuda",
                          torch.float32, cfg32.model)
            o = generate_tokens(p_exp, cfg32.model, b, **{**kw, "max_new_tokens":
                                                          max(budgets[s:s + 8])})
            ref += [r[: min(n_, bud)] for r, n_, bud in zip(o.tokens.tolist(),
                                                            o.lengths.tolist(),
                                                            budgets[s:s + 8])]
        diff = [i for i, (a, b) in enumerate(zip(run_e["tokens"], ref)) if a != b]
        check(not diff, f"f32 hubert_base engine != generate_tokens for requests {diff}")
        res["engine_f32"] = dict(serving_numbers(run_e, eng=eng),
                                 tokens_equal_generate_tokens=True)
        del eng
        settle()

        # exact streaming: the longest test utterance in 4 feeds, no commit
        # before finalize (agree_n 5 > 4 feeds + finalize - 1)
        cfg_st = hubert_base([*over32, "decode.max_new_tokens=32"])
        audio = max((s.audio for s in samples), key=len)
        cut = np.linspace(0, len(audio), 5).astype(int)

        def stream():
            stt = StreamingTranscriber(p_exp, cfg_st, tok, agree_n=5)
            for a, b in zip(cut[:-1], cut[1:]):
                stt.feed(audio=audio[a:b])
            stt.finalize()
            return stt

        stt = counted("hubert_stream_f32", stream)
        b1 = featurize(collate([Sample("x", audio, None, "", [tok.eos_id])], cfg_st.data,
                               prompt, tok.pad_id), "cuda", torch.float32,
                       cfg_st.model)
        off = generate_tokens(p_exp, cfg_st.model, b1, **kw)
        off_ids = off.tokens[0, : int(off.lengths[0])].tolist()
        off_ids = off_ids[:-1] if off_ids and off_ids[-1] == tok.eos_id else off_ids
        check(stt.committed_tokens == off_ids, "f32 hubert_base streaming != offline decode")
        check(by_path["hubert_stream_f32"] == want(flash=(nH + nL) * 5),
              f"exact streaming launches {by_path['hubert_stream_f32']}")
        res["stream_exact_f32"] = dict(feeds=4, seconds=len(audio) / 16000,
                                       committed=len(off_ids), finalize_equals_offline=True)
        print("convert hubert_base f32: the export equals the in-memory conversion; the "
              "engine and exact streaming equal generate_tokens; "
              + json.dumps(res["engine_f32"]["stats"]))
        del p_exp, stt, b1, off
        settle()
        shutil.rmtree(base / "export_hubert_base", ignore_errors=True)

        # 5. a reference-trainer checkpoint at the flagship's width and
        # MESH_DEPTH: the peft-wrapped LLM in bf16 with r = 16 LoRA, simple
        # connectors in f32
        rc = flagship(list(MESH_DEPTH))
        gen = torch.Generator(device="cuda").manual_seed(seed + 1602)
        llm = jitter(init_llama(gen, rc.model.llm, torch.bfloat16), gen)
        r = rc.model.lora.r
        sd = {}
        for k, v in hf_llama_state(llm).items():
            k = "llm.base_model.model." + k
            for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
                k = k.replace(f".{proj}.weight", f".{proj}.base_layer.weight")
            sd[k] = v
        sd["llm.base_model.model.lm_head.weight"] = llm["embed"]
        lora = {}
        for i, layer in enumerate(llm["layers"]):
            for ours, proj in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                               ("o", "o_proj")):
                d_in, d_out = layer[ours]["w"].shape
                A = 0.02 * torch.randn((r, d_in), generator=gen, device="cuda")
                B = 0.02 * torch.randn((d_out, r), generator=gen, device="cuda")
                pre = f"llm.base_model.model.model.layers.{i}.self_attn.{proj}"
                sd[f"{pre}.lora_A.default.weight"] = A.to(torch.bfloat16)
                sd[f"{pre}.lora_B.default.weight"] = B.to(torch.bfloat16)
                lora[(i, ours)] = (sd[f"{pre}.lora_A.default.weight"],
                                   sd[f"{pre}.lora_B.default.weight"])
        conn = {}
        for side, d_in in (("audio_connector", rc.model.audio_dim),
                           ("video_connector", rc.model.video_dim)):
            conn[side] = (0.02 * torch.randn((rc.model.llm.d_model, d_in), generator=gen,
                                             device="cuda"),
                          0.02 * torch.randn((rc.model.llm.d_model,), generator=gen,
                                             device="cuda"))
            sd[f"{side}.linear.weight"], sd[f"{side}.linear.bias"] = conn[side]
        pt = base / "model_best.pt"
        t0 = time.perf_counter()
        on_host: dict[int, torch.Tensor] = {}      # a tied tensor is saved once
        for k, v in sd.items():
            if id(v) not in on_host:
                on_host[id(v)] = v.cpu()
            sd[k] = on_host[id(v)]
        torch.save({"epoch": 3, "model_state_dict": sd, "train_losses": [2.0, 1.5]}, pt)
        del sd
        write_s = time.perf_counter() - t0
        ref_out = base / "export_ref"
        t0 = time.perf_counter()
        check(convert_ref_ckpt.main(["--device", "cuda",
                                     "--checkpoint", str(pt), "--out", str(ref_out),
                                     *FLAGSHIP_OVERRIDES, *MESH_DEPTH]) == 0,
              "convert_ref_ckpt failed")
        conv_s = time.perf_counter() - t0
        exp = path_leaves(load_params(ref_out))
        n = same("ref/llm", exp, path_leaves({"llm": llm}))
        for (i, ours), (A, B) in lora.items():
            p = f"llm/layers/{i}/{ours}/lora/"
            check(torch.equal(exp[p + "a"].cuda(), A.float().T)
                  and torch.equal(exp[p + "b"].cuda(), B.float().T),
                  f"ref: LoRA of layer {i} {ours} is not (Aᵀ, Bᵀ)")
        for side, (W, b) in conn.items():
            check(torch.equal(exp[f"{side}/out/w"].cuda(), W.T)
                  and torch.equal(exp[f"{side}/out/b"].cuda(), b),
                  f"ref: {side} is not (Wᵀ, b)")
        res["ref_ckpt"] = dict(pt_gb=pt.stat().st_size / 1e9, write_s=write_s,
                               convert_s=conv_s, export_gb=gb(ref_out),
                               base_leaves_equal=n, lora_pairs_equal=len(lora))
        del exp, llm, lora, conn
        settle()
        params = common.load_decode_params(rc, str(ref_out), seed=seed, device="cuda")
        hb8 = serving_host_batch(rc, seed + 1603)
        st: dict = {}
        out = counted("ref_generate_bf16", lambda: generate_tokens(
            params, rc.model, featurize(hb8, "cuda", torch.bfloat16), max_new_tokens=32,
            eos_id=-1, compute_dtype=torch.bfloat16, stats=st))
        check(out.tokens.shape == (8, 32) and bool(torch.isfinite(st["prefill_logits"]).all()),
              "the reference export's decode")
        check(by_path["ref_generate_bf16"]
              == want(flash=rc.model.whisper.n_layers + rc.model.llm.n_layers),
              f"reference export decode launches {by_path['ref_generate_bf16']}")
        print("convert reference checkpoint: " + json.dumps(res["ref_ckpt"]))
        del params, out, st
        settle()
    finally:
        shutil.rmtree(base, ignore_errors=True)
    check(not base.exists(), f"{base} not removed")

    # 6. the flash forward at the HuBERT shape
    res["hubert_kernel"] = dict(
        hubert_kernel_row(seed),
        launches_per_hubert_encoder_call=by_path["hubert_encoder_bf16"]["flash_fwd"])
    res["launches_by_path"] = by_path
    res["seconds"] = time.perf_counter() - t_all
    print(f"convert phase: {res['seconds']:.1f} s; launches " + json.dumps(by_path))
    return res


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# Phase 17: every connector at full width, the flash kernels at D = 256
# ---------------------------------------------------------------------------

CONNECTORS = ("deep", "conv", "attention", "adaptive", "cross_modal", "qformer",
              "perceiver", "adapter")
# the connectors that attend over the audio features with 8 heads of 256
# (the flagship's 2048-wide LLM): one flash forward per encode at T = 500
# (adaptive pools by 4 only past 512 rows), one dQ and one dK/dV per step
ATTENTIVE = ("attention", "adaptive")


def connector_launches(name: str, n_feat: int, prompt: int, labels: int,
                       n_whisper: int = 24, n_llm: int = 16) -> dict[str, dict[str, int]]:
    """The flash launches each path makes with connector ``name``, derived
    from the code: Whisper's 24 layers over 500 frames; the attention and
    adaptive connectors' one attention at head width 256 over the 500
    features; and the LLM's 16 layers only where the packed width reaches
    the dispatch threshold (``ops/attention.py::MIN_KERNEL_SEQ``): the
    prefix of ``prompt`` + ``n_feat`` rows for a prefill, the packed
    [prompt][features][labels] width rounded up to 16 for a train step
    (forward and remat's recompute). ``qformer``'s 32 and ``perceiver``'s
    64 features keep both under it."""
    from avsr_tpu_torch.ops.attention import MIN_KERNEL_SEQ

    extra = 1 if name in ATTENTIVE else 0
    prefill = n_llm if prompt + n_feat >= MIN_KERNEL_SEQ else 0
    width = -(-(prompt + n_feat + labels) // 16) * 16
    step = n_llm if width >= MIN_KERNEL_SEQ else 0
    return dict(encode=dict(fwd=n_whisper + extra, dq=0, dkv=0),
                generate=dict(fwd=n_whisper + extra + prefill, dq=0, dkv=0),
                train_step=dict(fwd=n_whisper + extra + 2 * step, dq=extra + step,
                                dkv=extra + step))


def connector_kernel_rows(seed: int) -> dict:
    """The flash forward, dQ and dK/dV at the connectors' shape: q = k = v
    [8, 8, T, 256], non-causal, over 10 s of audio (the 500 Whisper frames
    the encoder returns, trimmed from its 512 padded rows: the width the
    main path launches, not a multiple of 64), a ragged set at 512 rows and
    the 30 s ``adaptive`` shape (1500 frames pooled to 375). Each form the
    connector paths launch (bf16 and f32 forward, bf16 and f32 dQ and dK/dV)
    is held to its plain version; the bf16 kernels are timed at T = 500 from
    replayed CUDA graphs beside their bound, their plain versions and SDPA."""
    import torch

    from avsr_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(seed + 1700)

    def qkv(T: int):
        return [torch.randn((8, 8, T, 256), generator=gen, device="cuda",
                            dtype=torch.bfloat16) for _ in range(4)]

    def lengths(*n: int):
        return torch.tensor(n if len(n) == 8 else n * 8, dtype=torch.int32, device="cuda")

    q, k, v, do = qkv(500)
    lens = lengths(500)
    cases = (("main", (q, k, v, do), lens),
             ("ragged", qkv(512), lengths(500, 311, 260, 512, 17, 400, 256, 1)),
             ("30s", qkv(375), lengths(375)))
    err = {"bf16": 0.0, "f32": 0.0}
    lse_err = {"bf16": 0.0, "f32": 0.0}
    bwd_err = {f"{n}_{dt}": 0.0 for n in ("dq", "dk", "dv") for dt in ("bf16", "f32")}
    for tag, tensors, ln in cases:
        n = int(ln.min())
        for dt, tol, lse_tol, bwd_tol in (("bf16", 2e-2, 1e-3, 2e-2), ("f32", 1e-4, 1e-4, 1e-4)):
            q_, k_, v_, do_ = (t.float() if dt == "f32" else t for t in tensors)
            o, lse = A.flash_attention(q_, k_, v_, ln, ln, False)
            o_r, lse_r = A.flash_attention_reference(q_, k_, v_, ln, ln, False)
            torch.cuda.synchronize()
            e = (o.float() - o_r.float()).abs()
            check(bool((e <= tol + tol * o_r.float().abs()).all()),
                  f"connector/{tag}/{dt}: O off by {e.max().item():.3e} (atol=rtol={tol})")
            fin = torch.isfinite(lse_r)
            check(torch.equal(fin, torch.isfinite(lse)), f"connector/{tag}/{dt}: lse +inf rows")
            le = (lse[fin] - lse_r[fin]).abs().max().item()
            check(le <= lse_tol, f"connector/{tag}/{dt}: lse off by {le:.3e} (atol {lse_tol})")
            check(bool((o[ln == n][:, :, n:] == 0).all()), f"connector/{tag}/{dt}: padded rows")
            err[dt], lse_err[dt] = max(err[dt], e.max().item()), max(lse_err[dt], le)

            dq, delta = A.flash_bwd_dq(q_, k_, v_, o, lse, do_, ln, ln, False)
            dk, dv = A.flash_bwd_dkv(q_, k_, v_, lse, delta, do_, ln, ln, False)
            refs = A.flash_attention_bwd_reference(q_, k_, v_, o, lse, do_, ln, ln, False)
            delta_r = A.flash_bwd_dq_reference(q_, k_, v_, o, lse, do_, ln, ln, False)[1]
            torch.cuda.synchronize()
            d_err = (delta - delta_r).abs().max().item()
            check(d_err <= 1e-4 * max(1.0, delta_r.abs().max().item()),
                  f"connector/{tag}/{dt}: delta off by {d_err:.3e}")
            for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
                check(bool(torch.isfinite(got.float()).all()),
                      f"connector/{tag}/{dt}: {name} not finite")
                r = rel_err(got, ref)
                check(r <= bwd_tol, f"connector/{tag}/{dt}: {name} max|d| {r:.3e} x max|ref| "
                                    f"> {bwd_tol}")
                bwd_err[f"{name}_{dt}"] = max(bwd_err[f"{name}_{dt}"], r)
            del o, lse, o_r, lse_r, dq, delta, dk, dv, refs, delta_r
    print(f"kernel connector (D = 256): forward, dQ and dK/dV held to their plain versions "
          f"(main, ragged, 30 s): max|dO| bf16 {err['bf16']:.3e}, f32 {err['f32']:.3e}; "
          "max|d|/max|ref| " + ", ".join(f"{n_} {e_:.3e}" for n_, e_ in bwd_err.items()))

    bounds = attn_bounds(q, k, lens, lens, False)
    o, lse = A.flash_attention(q, k, v, lens, lens, False)
    args_dq = (q, k, v, o, lse, do, lens, lens, False)
    _, delta = A.flash_bwd_dq(*args_dq)
    args_dkv = (q, k, v, lse, delta, do, lens, lens, False)
    times = {"fwd": graph_ms([lambda: A.flash_attention(q, k, v, lens, lens, False)]),
             "dq": graph_ms([lambda: A.flash_bwd_dq(*args_dq)]),
             "dkv": graph_ms([lambda: A.flash_bwd_dkv(*args_dkv)])}
    plain = {"fwd": time_ms(lambda: A.flash_attention_reference(q, k, v, lens, lens, False), 3),
             "dq": time_ms(lambda: A.flash_bwd_dq_reference(*args_dq), 3),
             "dkv": time_ms(lambda: A.flash_bwd_dkv_reference(*args_dkv), 3)}
    lib_fwd = sdpa_ms(q, k, v, lens, False)
    lib_bwd = sdpa_ms(q, k, v, lens, False, do)
    rows = {}
    for name in ("fwd", "dq", "dkv"):
        ops_ms, bytes_ms = bounds[name]
        lib = lib_fwd if name == "fwd" else lib_bwd
        rows[name] = dict(
            shape="connector", q=list(q.shape), kv=list(k.shape), causal=False, lens=500,
            ms=times[name], plain_ms=plain[name], library_ms=lib["ms"], library=lib,
            bound_ms=max(ops_ms, bytes_ms), ops_ms=ops_ms, bytes_ms=bytes_ms,
            bound_by="operations" if ops_ms >= bytes_ms else "bytes")
    rows["fwd"].update(max_abs_err=err["bf16"], max_lse_err=lse_err["bf16"],
                       f32=dict(max_abs_err=err["f32"], max_lse_err=lse_err["f32"]))
    rows["dq"]["max_rel_err"] = dict(bf16=bwd_err["dq_bf16"], f32=bwd_err["dq_f32"])
    rows["dkv"]["max_rel_err"] = {k_: v_ for k_, v_ in bwd_err.items() if k_[:2] in ("dk", "dv")}
    print(f"kernel connector ({gpu_line()}): forward {times['fwd']:.4f} ms (plain "
          f"{plain['fwd']:.4f}, SDPA {lib_fwd['ms']:.4f} [{lib_fwd['call']}], bound "
          f"{rows['fwd']['bound_ms']:.4f} by {rows['fwd']['bound_by']}); dQ {times['dq']:.4f} "
          f"(plain {plain['dq']:.4f}, bound {rows['dq']['bound_ms']:.4f}), dK/dV "
          f"{times['dkv']:.4f} (plain {plain['dkv']:.4f}, bound {rows['dkv']['bound_ms']:.4f}), "
          f"SDPA backward {lib_bwd['ms']:.4f} ms")
    return rows


def connector_phase(seed: int) -> dict:
    """Phase 17: each of the eight connectors at the flagship's full width
    (see the module docstring)."""
    import shutil

    import torch

    from avsr_tpu_torch.cli import decode, train
    from avsr_tpu_torch.convert import cast_tree
    from avsr_tpu_torch.core.config import flagship
    from avsr_tpu_torch.data.loader import featurize
    from avsr_tpu_torch.data.tokenizer import ByteTokenizer
    from avsr_tpu_torch.infer.engine import ServingEngine
    from avsr_tpu_torch.infer.generate import generate_tokens, prepare_params_for_decode
    from avsr_tpu_torch.models.avsr import encode, init_avsr_model
    from avsr_tpu_torch.models.connectors import get_connector
    from avsr_tpu_torch.models.whisper_encoder import whisper_encoder_apply
    from avsr_tpu_torch.train.state import cast_frozen

    t_all = time.perf_counter()
    res: dict = {"kernels": connector_kernel_rows(seed)}
    by_path: dict[str, dict[str, int]] = {}
    nW, nL = 24, 16                 # Whisper and LLM layers: flash per encode, prefill

    def counted(tag: str, fn):
        torch.cuda.synchronize()
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        by_path[tag] = counts()
        return out

    def want(flash=0, dq=0, dkv=0) -> dict[str, int]:
        return dict(flash_fwd=flash, flash_bwd_dq=dq, flash_bwd_dkv=dkv, qmatmul_int8=0,
                    qmatmul_int4=0)

    # the flagship's encoders and LLM once, bf16, from --seed; each connector's
    # own leaves from seed + 1700
    base = init_avsr_model(flagship().model, seed=seed, device="cuda", dtype=torch.bfloat16)
    for side in ("audio_connector", "video_connector"):
        del base[side]

    def with_connector(mc, dtype, tree=None):
        gen = torch.Generator(device="cuda").manual_seed(seed + 1700)
        conn, d = get_connector(mc.connector_type), mc.llm.d_model
        params = dict(tree if tree is not None else base)
        if conn.dual:
            params["connector"] = conn.init(gen, mc.audio_dim, mc.video_dim, d, mc, dtype)
        else:
            params["audio_connector"] = conn.init(gen, mc.audio_dim, d, mc, dtype)
            params["video_connector"] = conn.init(gen, mc.video_dim, d, mc, dtype)
        return params

    tok = ByteTokenizer()
    cfg0 = flagship()
    hb = serving_host_batch(cfg0, seed)
    batch = featurize(hb, "cuda", torch.bfloat16)
    micro = featurize(train_host_batch(cfg0, tok, np.random.default_rng(seed + 1701)),
                      "cuda", torch.bfloat16)
    stacked = _stack([micro])
    rows = {}
    derived = {}
    for name in CONNECTORS:
        cfg = flagship([f"model.connector_type={name}", "training.grad_accum_steps=1"])
        mc = cfg.model
        n_feat = {"qformer": mc.qformer_queries, "perceiver": mc.perceiver_latents}.get(name, 500)
        d = derived[name] = connector_launches(name, n_feat, hb.prompt.shape[1],
                                               micro.labels.shape[1], nW, nL)
        params = with_connector(mc, torch.bfloat16)
        kw = dict(max_new_tokens=32, eos_id=-1, compute_dtype=torch.bfloat16)
        generate_tokens(params, mc, batch, **{**kw, "max_new_tokens": 2})     # warm-up
        torch.cuda.reset_peak_memory_stats()
        st: dict = {}
        out = counted(f"{name}_generate", lambda: generate_tokens(params, mc, batch, stats=st,
                                                                  **kw))
        peak = torch.cuda.max_memory_allocated() / 1e9
        w = want(*d["generate"].values())
        check(by_path[f"{name}_generate"] == w,
              f"{name}: generate launches {by_path[f'{name}_generate']}, expected {w}")
        check(out.tokens.shape == (8, 32) and bool((out.lengths == 32).all())
              and bool(((out.tokens >= 0) & (out.tokens < mc.llm.vocab_size)).all()),
              f"{name}: tokens {tuple(out.tokens.shape)}")
        check(bool(torch.isfinite(st["prefill_logits"]).all()), f"{name}: prefill logits")
        with torch.no_grad():
            enc = counted(f"{name}_encode", lambda: encode(params, mc, batch,
                                                           compute_dtype=torch.bfloat16))
        check(enc.features.shape == (8, n_feat, mc.llm.d_model)
              and bool(torch.isfinite(enc.features.float()).all())
              and enc.lengths.tolist() == [n_feat] * 8,
              f"{name}: features {tuple(enc.features.shape)}, lengths {enc.lengths.tolist()}")
        check(by_path[f"{name}_encode"] == want(*d["encode"].values()),
              f"{name}: encode launches {by_path[f'{name}_encode']}")
        if name in ATTENTIVE:
            # the audio connector's own launches, counted apart from
            # Whisper's: one call on the 500 encoder frames, and one forward
            # and backward of it (the gradient reaches q, k and v through
            # the features, as the connector's leaves' does in a train step)
            conn = get_connector(name)
            with torch.no_grad():
                feats, alens = whisper_encoder_apply(
                    params["whisper"], batch.mel, mc.whisper, mel_lengths=batch.mel_lens,
                    compute_dtype=torch.bfloat16)
            check(feats.shape[1] == 500, f"{name}: Whisper gives {feats.shape[1]} rows, not 500")
            with torch.no_grad():
                counted(f"{name}_audio_connector", lambda: conn.apply(
                    params["audio_connector"], feats, alens, use_kernel="auto"))
            check(by_path[f"{name}_audio_connector"] == want(flash=1),
                  f"{name}: audio connector launches {by_path[f'{name}_audio_connector']}")
            feats.requires_grad_(True)

            def connector_grad():
                y, _ = conn.apply(params["audio_connector"], feats, alens, use_kernel="auto")
                y.float().square().mean().backward()

            counted(f"{name}_audio_connector_grad", connector_grad)
            check(by_path[f"{name}_audio_connector_grad"] == want(1, 1, 1),
                  f"{name}: audio connector forward and backward launches "
                  f"{by_path[f'{name}_audio_connector_grad']}")
            check(bool(torch.isfinite(feats.grad.float()).all()), f"{name}: feature gradient")
            del feats, alens

        # one LoRA train step of 8 (accum 1) after a warm-up step; the
        # connector and LoRA leaves f32, the frozen ones bf16
        tparams = cast_frozen(params, mc, torch.bfloat16)
        _, tr = _run_steps(cfg, tparams, stacked, 2, f"connector {name}", seed,
                           expect=want(*d["train_step"].values()))
        by_path[f"{name}_train_2_steps"] = {
            k_: sum(s_["launches"][k_] for s_ in tr["steps"]) for k_ in counts()}
        rows[name] = dict(
            encode_ms=st["encode_s"] * 1e3, prefill_ms=st["prefill_s"] * 1e3,
            ms_per_token=st["decode_s"] * 1e3 / st["decode_steps"], peak_mem_gb=peak,
            features=n_feat, train_step_ms=tr["steps"][-1]["ms"],
            train_first_step_ms=tr["steps"][0]["ms"], train_peak_mem_gb=tr["peak_mem_gb"],
            launches_derived=d)
        print(f"connector {name}: " + json.dumps(rows[name]))
        del params, tparams, out, enc, st
        settle()
    res["connectors"] = rows

    # f32 exactness: the engine (4 slots, 8 ragged requests) token for token
    # equal to generate_tokens, with the f32 kernel at D = 256 (attention) and
    # fixed-length features (qformer)
    samples, budgets = serving_traffic(seed + 17, n=8)
    budgets = [min(b, 16) for b in budgets]
    b32 = cast_tree(base, torch.float32)
    for name in ("attention", "qformer"):
        cfg32 = flagship(["runtime.compute_dtype=float32", f"model.connector_type={name}"])
        p32 = prepare_params_for_decode(with_connector(cfg32.model, torch.float32, b32),
                                        cfg32.model)
        eng = ServingEngine(p32, cfg32, tok, num_slots=4, k_steps=8, seed=seed)
        try:
            run = counted(f"{name}_engine_f32", lambda: drive_engine(eng, samples, budgets))
            stages = eng.stages_run
        finally:
            eng.close()
        ref = static_batches(p32, cfg32, samples, budgets, torch.float32)
        diff = [i for i, (a, b_) in enumerate(zip(run["tokens"], ref["tokens"])) if a != b_]
        check(not diff, f"{name}: f32 engine != generate_tokens for requests {diff}")
        per_stage = derived[name]["generate"]["fwd"]
        check(by_path[f"{name}_engine_f32"] == want(flash=per_stage * stages),
              f"{name}: f32 engine launches {by_path[f'{name}_engine_f32']}, "
              f"{stages} stages of {per_stage}")
        res[f"engine_f32_{name}"] = dict(requests=8, slots=4, stages=stages,
                                         tokens_equal_generate_tokens=True,
                                         new_tokens=sum(len(t) for t in run["tokens"]))
        print(f"connector {name}: f32 engine equals generate_tokens token for token "
              f"({stages} stages)")
        del p32, eng
        settle()
    del b32, base
    settle()

    # the train and decode CLIs with cross_modal on phase 15's corpus
    work = ROOT / "outputs" / "chip_smoke" / time.strftime("connector_%Y%m%d_%H%M%S")
    try:
        corpus = make_corpus(work, seed)
        flag = ["--seed", str(seed), "--device", "cuda", *FLAGSHIP_OVERRIDES,
                "data.synthetic=false", f"data.path={corpus}", "data.num_workers=4",
                "model.connector_type=cross_modal"]
        run = work / "run"

        def train_run():
            rc = train.main([*flag, "training.grad_accum_steps=1", "training.max_steps=2",
                             "training.save_every_steps=0", f"training.checkpoint_dir={run}"])
            check(rc == 0, f"train CLI (cross_modal) returned {rc}")
            rows_ = loss_rows(run)
            tr_ = [r for r in rows_ if r[2] == "train"]
            check(len(tr_) == 2 and all(np.isfinite(float(r[3])) for r in tr_),
                  f"cross_modal train rows {tr_}")
            check([r[2] for r in rows_].count("val") == 1, "cross_modal: no validation row")
            return [float(r[3]) for r in tr_]

        losses = counted("cross_modal_train_cli", train_run)
        # 2 steps of 8: Whisper 24 without grad, the LLM's 16 and their
        # recompute; the 12 validation utterances in 2 batches of 24 + 16
        w = want(flash=2 * (nW + 2 * nL) + 2 * (nW + nL), dq=2 * nL, dkv=2 * nL)
        check(by_path["cross_modal_train_cli"] == w,
              f"cross_modal train CLI launches {by_path['cross_modal_train_cli']}, expected {w}")

        def decode_run():
            out = work / "dec"
            rc = decode.main([*flag, "decode.max_new_tokens=32", f"decode.output_dir={out}",
                              "--checkpoint", str(run / "ckpt"), "--split", "test"])
            check(rc == 0, f"decode CLI (cross_modal) returned {rc}")
            (res_f,), (wer_f,) = out.glob("results_*.txt"), out.glob("wer_*.txt")
            check(res_f.read_text().count("UTT: ") == 12
                  and "utterances: 12\n" in wer_f.read_text(),
                  "cross_modal decode: the test split's 12 utterances were not each scored once")
            m = re.search(r"WER: ([0-9.]+)", wer_f.read_text())
            check(m is not None and np.isfinite(float(m.group(1))), "cross_modal decode: no WER")
            return float(m.group(1))

        wer = counted("cross_modal_decode_cli", decode_run)
        check(by_path["cross_modal_decode_cli"] == want(flash=2 * (nW + nL)),
              f"cross_modal decode CLI launches {by_path['cross_modal_decode_cli']}")
        res["cli_cross_modal"] = dict(train_losses=losses, test_wer=wer)
        print(f"connector cross_modal CLIs on the corpus: losses {losses}, test WER {wer}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    res["launches_by_path"] = by_path
    res["seconds"] = time.perf_counter() - t_all
    print(f"connector phase: {res['seconds']:.1f} s")
    return res


# ---------------------------------------------------------------------------
# Phase 18: mixture of experts at full width
# ---------------------------------------------------------------------------

# the moe connector (8 experts, top-2, capacity factor 1.25, hidden 2 x 2048)
# and every second Llama block sparse (8 experts, top-2)
MOE_OVERRIDES = ("model.connector_type=moe", "model.llm.moe_experts=8",
                 "model.llm.moe_topk=2", "model.llm.moe_every=2")
# both capacity factors at 0.25: the bounded routings drop tokens
MOE_SQUEEZE = ("model.moe_capacity_factor=0.25", "model.llm.moe_capacity_factor=0.25")


def flagship_moe(extra=()):
    """``flagship()`` with both MoE forms (``MOE_OVERRIDES``)."""
    from avsr_tpu_torch.core.config import flagship

    return flagship([*MOE_OVERRIDES, *extra])


def moe_traffic(seed: int):
    """8 requests of 4-14 s synthetic audio + 25 frames from ``seed``, in
    the 10 s and 20 s buckets, with budgets of 8-16 new tokens."""
    from avsr_tpu_torch.data.dataset import Sample

    rng = np.random.default_rng(seed + 1800)
    secs = [4.3, 12.6, 9.8, 5.1, 13.7, 7.2, 4.0, 10.9]
    samples, budgets = [], []
    for i, sec in enumerate(secs):
        ns = int(sec * 16000)
        t = np.arange(ns, dtype=np.float32) / 16000.0
        audio = (0.3 * np.sin(2 * np.pi * rng.uniform(80, 300) * t)
                 + 0.05 * rng.standard_normal(ns)).astype(np.float32)
        frames = rng.integers(0, 256, (25, 224, 224, 3), dtype=np.uint8)
        samples.append(Sample(f"moe/{i}", audio, frames, "", [257]))
        budgets.append(int(rng.integers(8, 17)))
    return samples, budgets


def moe_phase(seed: int) -> dict:
    """Phase 18: ``flagship_moe()`` at full width (see the module
    docstring): a static bf16 call, a bf16 train step of 8 repeated bit for
    bit, the serving preset, and in f32 the engine, speculative decoding,
    beam search and the decode CLI, with launches derived from the tree."""
    import shutil

    import torch

    from avsr_tpu_torch.cli import common, decode
    from avsr_tpu_torch.convert import cast_tree, param_count
    from avsr_tpu_torch.data.loader import featurize
    from avsr_tpu_torch.data.tokenizer import ByteTokenizer
    from avsr_tpu_torch.infer import speculative as S
    from avsr_tpu_torch.infer.engine import ServingEngine
    from avsr_tpu_torch.infer.generate import (beam_search, generate_tokens,
                                               prepare_params_for_decode)
    from avsr_tpu_torch.models.avsr import init_avsr_model
    from avsr_tpu_torch.models.llama import is_moe_layer
    from avsr_tpu_torch.ops.quant import is_quantized
    from avsr_tpu_torch.train.state import cast_frozen, create_train_state, path_leaves
    from avsr_tpu_torch.train.step import make_train_step

    t_all = time.perf_counter()
    res: dict = {}
    by_path: dict[str, dict[str, int]] = {}

    def counted(tag: str, fn):
        torch.cuda.synchronize()
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        by_path[tag] = counts()
        return out

    def want(flash=0, dq=0, dkv=0, int8=0, int4=0) -> dict[str, int]:
        return dict(flash_fwd=flash, flash_bwd_dq=dq, flash_bwd_dkv=dkv, qmatmul_int8=int8,
                    qmatmul_int4=int4)

    def quantized_per_step(llm) -> int:
        """The quantized products of one decode step: every quantized node
        of the layers (a MoE block has no gate/up/down)."""
        return sum(is_quantized(v) for layer in llm["layers"] for v in layer.values())

    cfg = flagship_moe()
    mc = cfg.model
    nW, nL = mc.whisper.n_layers, mc.llm.n_layers
    n_moe = sum(is_moe_layer(mc.llm, i) for i in range(nL))
    tok = ByteTokenizer()
    hb = serving_host_batch(cfg, seed)
    B = len(hb.utt_ids)
    d = connector_launches("moe", 500, hb.prompt.shape[1], cfg.data.max_label_length, nW, nL)

    # ---- a static bf16 call (B = 8, 10 s, 25 frames, 32 tokens) ----------
    t0 = time.perf_counter()
    params = init_avsr_model(mc, seed=seed, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    experts = sum(t.numel() for k, t in path_leaves(params).items() if "experts" in k)
    print(f"moe: random init of {param_count(params) / 1e9:.3f} B params (bf16, "
          f"{experts / 1e9:.3f} B in experts; {n_moe} of {nL} LLM blocks sparse) in "
          f"{time.perf_counter() - t0:.2f} s")
    batch = featurize(hb, "cuda", torch.bfloat16)
    kw = dict(max_new_tokens=32, eos_id=-1, compute_dtype=torch.bfloat16)
    generate_tokens(params, mc, batch, **{**kw, "max_new_tokens": 2})       # warm-up
    torch.cuda.reset_peak_memory_stats()
    st: dict = {}
    out = counted("moe_generate", lambda: generate_tokens(params, mc, batch, stats=st, **kw))
    peak = torch.cuda.max_memory_allocated() / 1e9
    w = want(*d["generate"].values())
    check(by_path["moe_generate"] == w, f"moe generate launches {by_path['moe_generate']}, "
                                        f"expected {w}")
    check(out.tokens.shape == (B, 32) and bool((out.lengths == 32).all())
          and bool(((out.tokens >= 0) & (out.tokens < mc.llm.vocab_size)).all()),
          f"moe tokens {tuple(out.tokens.shape)}")
    check(bool(torch.isfinite(st["prefill_logits"]).all()), "moe prefill logits")
    res["static_bf16"] = dict(
        encode_ms=st["encode_s"] * 1e3, prefill_ms=st["prefill_s"] * 1e3,
        ms_per_token=st["decode_s"] * 1e3 / st["decode_steps"], peak_mem_gb=peak,
        params_b=param_count(params) / 1e9, expert_params_b=experts / 1e9, launches=w)
    print("moe static bf16: " + json.dumps(res["static_bf16"]))

    # ---- a bf16 train step of 8, and the same step again from the same state
    tcfg = flagship_moe(["training.grad_accum_steps=1"])
    micro = featurize(train_host_batch(tcfg, tok, np.random.default_rng(seed + 1801)),
                      "cuda", torch.bfloat16)
    stacked = _stack([micro])
    # two trees of the same values: trainable leaves (the connectors' routers
    # and experts, LoRA) in f32 each, the frozen bf16 leaves shared
    ta, tb = cast_frozen(params, mc, torch.bfloat16), cast_frozen(params, mc, torch.bfloat16)
    state_a, tr = _run_steps(tcfg, ta, stacked, 2, "moe train", seed,
                             expect=want(*d["train_step"].values()))
    by_path["moe_train_2_steps"] = {k: sum(s_["launches"][k] for s_ in tr["steps"])
                                    for k in counts()}
    state_b = create_train_state(tb, tcfg, total_steps=1000)
    step = make_train_step(tcfg)
    m_b = [step(state_b, stacked, seed + i) for i in range(2)]
    for i, s_ in enumerate(tr["steps"]):
        check(np.isfinite(s_["moe_lb"]) and np.isfinite(s_["moe_z"]) and s_["moe_lb"] > 0,
              f"moe train step {i + 1}: moe_lb {s_['moe_lb']}, moe_z {s_['moe_z']}")
        check(all(s_[k] == m_b[i][k] for k in ("loss", "grad_norm", "moe_lb", "moe_z")),
              f"moe train step {i + 1} repeated: {m_b[i]} != {s_}")
    la, lb = path_leaves(state_a.state_dict()), path_leaves(state_b.state_dict())
    diff = [k for k, v in la.items() if isinstance(v, torch.Tensor) and not torch.equal(v, lb[k])]
    check(not diff, f"moe train steps from one state differ in {diff[:5]}")
    res["train_bf16"] = dict(
        step_ms=tr["steps"][-1]["ms"], first_step_ms=tr["steps"][0]["ms"],
        peak_mem_gb=tr["peak_mem_gb"], moe_lb=tr["steps"][-1]["moe_lb"],
        moe_z=tr["steps"][-1]["moe_z"], loss=tr["steps"][-1]["loss"],
        split_ms={k: v for k, v in tr["steps"][-1].items() if k.endswith("_ms")},
        repeated_step_bit_equal=True, launches_per_step=tr["steps"][-1]["launches"])
    print("moe train bf16: " + json.dumps(res["train_bf16"]))
    del params, ta, tb, state_a, state_b, step, micro, stacked, batch, la, lb
    settle()

    # ---- the serving preset (int4 projections, int8 head and cache) ------
    pcfg = flagship_moe(PRESET_OVERRIDES)
    pp = common.load_decode_params(pcfg, seed=seed, device="cuda")
    per = quantized_per_step(pp["llm"])
    check(per == 4 * (nL - n_moe) + 2 * n_moe,
          f"preset: {per} quantized products per step, not 4 per dense and 2 per MoE block")
    check(all(not is_quantized(v) for lay in pp["llm"]["layers"] if "experts" in lay
              for k, v in lay.items() if k in ("router", "experts")), "preset: a router quantized")
    batch = featurize(hb, "cuda", torch.bfloat16)
    kq = dict(kw, kv_cache_dtype="int8")
    generate_tokens(pp, pcfg.model, batch, **{**kq, "max_new_tokens": 2})   # warm-up
    torch.cuda.reset_peak_memory_stats()
    stq: dict = {}
    outq = counted("moe_preset_generate",
                   lambda: generate_tokens(pp, pcfg.model, batch, stats=stq, **kq))
    peak_q = torch.cuda.max_memory_allocated() / 1e9
    steps = stq["decode_steps"]
    w = want(flash=nW + nL, int8=steps + 1, int4=per * steps)
    check(by_path["moe_preset_generate"] == w,
          f"moe preset launches {by_path['moe_preset_generate']}, expected {w}")
    check(outq.tokens.shape == (B, 32) and bool(torch.isfinite(stq["prefill_logits"]).all()),
          "moe preset tokens or logits")
    p32 = cast_tree(pp, torch.float32)
    l32, nxt = decode_step_logits(p32, pcfg.model, hb, torch.float32, ("auto", "never"))
    del p32
    settle()
    l16, _ = decode_step_logits(pp, pcfg.model, hb, torch.bfloat16, ("auto", "never"), nxt)
    ref = l32["never"]
    std = ref.std().item()
    d32, dk, dn = ((l32["auto"] - ref).abs(), (l16["auto"] - ref).abs(),
                   (l16["never"] - ref).abs())
    check(d32.mean().item() <= 1e-2 * std and d32.max().item() <= dn.max().item()
          and dk.mean().item() <= 2.0 * dn.mean().item(),
          f"moe preset decode step: f32 kernel vs dequantize mean {d32.mean().item():.4e}, "
          f"max {d32.max().item():.4e}; bf16 kernel {dk.mean().item():.4e} vs dequantize "
          f"{dn.mean().item():.4e} (std {std:.4e})")
    res["preset"] = dict(
        encode_ms=stq["encode_s"] * 1e3, prefill_ms=stq["prefill_s"] * 1e3,
        ms_per_token=stq["decode_s"] * 1e3 / steps, peak_mem_gb=peak_q,
        quantized_products_per_step=per, launches=w,
        decode_step_logits=dict(std_f32=std, f32_kernel_vs_dequant_mean=d32.mean().item(),
                                f32_kernel_vs_dequant_max=d32.max().item(),
                                bf16_kernel_vs_f32_mean=dk.mean().item(),
                                bf16_dequant_vs_f32_mean=dn.mean().item()))
    print("moe preset: " + json.dumps(res["preset"]))
    del pp, batch, l32, l16, ref, d32, dk, dn
    settle()

    # ---- f32 (TF32 off): kernels against plain, engine, speculative, beam --
    cfg32 = flagship_moe(["runtime.compute_dtype=float32", *MOE_SQUEEZE])
    m32 = cfg32.model
    raw32 = common.init_or_load_params(cfg32, seed=seed, device="cuda")
    p32 = prepare_params_for_decode(raw32, m32)
    b32 = featurize(hb, "cuda", torch.float32)
    k32 = dict(eos_id=-1, compute_dtype=torch.float32)
    sk: dict = {}
    sn: dict = {}
    generate_tokens(p32, m32, b32, max_new_tokens=1, stats=sk, **k32)
    generate_tokens(p32, m32, b32, max_new_tokens=1, stats=sn, use_kernel="never", **k32)
    lref = sn["prefill_logits"]
    dmax = (sk["prefill_logits"] - lref).abs().max().item()
    check(dmax <= 2e-2 * lref.std().item(),
          f"moe f32 prefill logits: kernel vs plain max|d| {dmax:.4e} > 2e-2 * std")
    res["f32_prefill_kernel_vs_plain"] = dict(max=dmax, std=lref.std().item())
    greedy32 = generate_tokens(p32, m32, b32, max_new_tokens=32, **k32)

    samples, budgets = moe_traffic(seed)
    eng = ServingEngine(p32, cfg32, tok, num_slots=4, k_steps=8, seed=seed)
    try:
        run = counted("moe_engine_f32", lambda: drive_engine(eng, samples, budgets))
        stages = eng.stages_run
        est = eng.stats()
    finally:
        eng.close()
    ref_run = static_batches(p32, cfg32, samples, budgets, torch.float32)
    diff = [i for i, (a, b_) in enumerate(zip(run["tokens"], ref_run["tokens"])) if a != b_]
    check(not diff, f"moe f32 engine != generate_tokens for requests {diff}")
    check(by_path["moe_engine_f32"] == want(flash=(nW + nL) * stages),
          f"moe f32 engine launches {by_path['moe_engine_f32']}, {stages} stages of {nW + nL}")
    res["engine_f32"] = dict(requests=len(samples), slots=4, stages=stages, stats=est,
                             tokens_equal_generate_tokens=True,
                             new_tokens=sum(len(t) for t in run["tokens"]),
                             audio_s=[round(len(s_.audio) / 16000, 2) for s_ in samples])
    print("moe f32 engine: " + json.dumps(res["engine_f32"]))

    draft = S.make_draft_params(raw32, m32, bits=8)
    dper = quantized_per_step(draft["llm"])
    (spec, sst) = counted("moe_spec_f32", lambda: S.speculative_generate(
        p32, draft, m32, b32, gamma=4, max_new_tokens=32, return_stats=True, **k32))
    check(torch.equal(spec.tokens, greedy32.tokens),
          f"moe f32 speculative != greedy: {(spec.tokens != greedy32.tokens).sum().item()} "
          f"tokens differ")
    w = want(flash=nW + 2 * nL, int8=(dper + 1) * sst["draft_steps"])
    check(by_path["moe_spec_f32"] == w,
          f"moe f32 speculative launches {by_path['moe_spec_f32']}, expected {w}")
    res["spec_f32"] = dict(sst, tokens_equal_greedy=True, draft_products_per_step=dper + 1)
    del draft
    stb: dict = {}
    beam = counted("moe_beam_f32", lambda: beam_search(p32, m32, b32, max_new_tokens=32,
                                                      num_beams=5, stats=stb, **k32))
    check(beam.tokens.shape == (B, 32) and bool(torch.isfinite(stb["scores"]).all()),
          "moe f32 beam")
    check(by_path["moe_beam_f32"] == want(flash=nW + nL),
          f"moe f32 beam launches {by_path['moe_beam_f32']}")
    res["beam_f32"] = dict(num_beams=5, tokens=32, steps=stb["decode_steps"],
                           scores_finite=True)
    print("moe f32 speculative and beam: " + json.dumps(
        {"spec": res["spec_f32"], "beam": res["beam_f32"]}))
    del p32, raw32, b32, greedy32, eng
    settle()

    # ---- the decode CLI on phase 15's corpus, static and engine, f32 ------
    work = ROOT / "outputs" / "chip_smoke" / time.strftime("moe_%Y%m%d_%H%M%S")
    rec = _Records()
    logging.getLogger("avsr_tpu_torch").addHandler(rec)
    try:
        corpus = make_corpus(work, seed)
        flag = ["--seed", str(seed), "--device", "cuda", *FLAGSHIP_OVERRIDES, *MOE_OVERRIDES,
                *MOE_SQUEEZE, "runtime.compute_dtype=float32", "data.synthetic=false",
                f"data.path={corpus}", "decode.max_new_tokens=16"]
        hyps = {}
        for tag, extra in (("static", []), ("engine", ["decode.engine_slots=4"])):
            out_dir = work / tag
            rc = counted(f"moe_decode_cli_{tag}", lambda: decode.main(
                [*flag, *extra, f"decode.output_dir={out_dir}", "--split", "test"]))
            check(rc == 0, f"moe decode CLI ({tag}) returned {rc}")
            (res_f,) = out_dir.glob("results_*.txt")
            hyps[tag] = [ln for ln in res_f.read_text().splitlines() if ln.startswith("HYP: ")]
            check(len(hyps[tag]) == 12, f"moe decode CLI ({tag}): {len(hyps[tag])} HYP lines")
        check(hyps["static"] == hyps["engine"], "moe decode CLI: engine HYP lines != static")
        check(by_path["moe_decode_cli_static"] == want(flash=2 * (nW + nL)),
              f"moe decode CLI launches {by_path['moe_decode_cli_static']}")
        cli_stages = rec.args("engine stats")[-1]["stages_run"]   # a dict is the args
        check(by_path["moe_decode_cli_engine"] == want(flash=cli_stages * (nW + nL)),
              f"moe decode CLI (engine) launches {by_path['moe_decode_cli_engine']}, "
              f"{cli_stages} stages")
        res["decode_cli_f32"] = dict(utterances=12, hyp_lines_equal=True,
                                     engine_stages=cli_stages)
        print(f"moe decode CLI (f32, the corpus's 12 test utterances): the engine's HYP lines "
              f"equal the static batches' ({cli_stages} engine stages)")
    finally:
        logging.getLogger("avsr_tpu_torch").removeHandler(rec)
        shutil.rmtree(work, ignore_errors=True)
    res["launches_by_path"] = by_path
    res["launches_derived"] = d
    res["seconds"] = time.perf_counter() - t_all
    print(f"moe phase: {res['seconds']:.1f} s; launches " + json.dumps(by_path))
    return res


# ---------------------------------------------------------------------------
# Phase 19: the ResNet, EfficientNet and AV-HuBERT video encoders at full width
# ---------------------------------------------------------------------------

VIDEO_ENCODERS = ("resnet", "efficientnet", "avhubert")


def _bn_state(name: str, bn: dict) -> dict:
    """A torch BatchNorm's keys (``num_batches_tracked`` too, as torch
    writes it)."""
    import torch

    return {f"{name}.weight": bn["scale"], f"{name}.bias": bn["b"],
            f"{name}.running_mean": bn["mean"], f"{name}.running_var": bn["var"],
            f"{name}.num_batches_tracked": torch.tensor(0, dtype=torch.int64)}


def hf_resnet_state(p: dict, n_labels: int = 1000) -> dict:
    """A ResNet tree of the port -> ``ResNetForImageClassification`` keys:
    the ``resnet.`` prefix and a random classifier."""
    import torch

    def conv_bn(name: str, c: dict) -> dict:
        return {f"resnet.{name}.convolution.weight": c["conv"]["w"],
                **_bn_state(f"resnet.{name}.normalization", c["bn"])}

    sd = conv_bn("embedder.embedder", p["stem"])
    for si, layers in enumerate(p["stages"]):
        for li, lp in enumerate(layers):
            pre = f"encoder.stages.{si}.layers.{li}."
            for ci, c in enumerate(lp["convs"]):
                sd.update(conv_bn(pre + f"layer.{ci}", c))
            if "shortcut" in lp:
                sd.update(conv_bn(pre + "shortcut", lp["shortcut"]))
    d = p["stages"][-1][-1]["convs"][-1]["conv"]["w"].shape[0]
    gen = torch.Generator().manual_seed(1)
    sd["classifier.1.weight"] = 0.01 * torch.randn((n_labels, d), generator=gen)
    sd["classifier.1.bias"] = torch.zeros(n_labels)
    return sd


def hf_efficientnet_state(p: dict, n_labels: int = 1000) -> dict:
    """An EfficientNet tree of the port -> ``EfficientNetForImageClassification``
    keys: the ``efficientnet.`` prefix and a random classifier."""
    import torch

    pre = "efficientnet."
    sd = {pre + "embeddings.convolution.weight": p["stem"]["conv"]["w"],
          **_bn_state(pre + "embeddings.batchnorm", p["stem"]["bn"])}
    for i, b in enumerate(p["blocks"]):
        bp = f"{pre}encoder.blocks.{i}."
        if "expand" in b:
            sd[bp + "expansion.expand_conv.weight"] = b["expand"]["conv"]["w"]
            sd.update(_bn_state(bp + "expansion.expand_bn", b["expand"]["bn"]))
        sd[bp + "depthwise_conv.depthwise_conv.weight"] = b["dw"]["conv"]["w"]
        sd.update(_bn_state(bp + "depthwise_conv.depthwise_norm", b["dw"]["bn"]))
        for n in ("reduce", "expand"):
            sd[f"{bp}squeeze_excite.{n}.weight"] = b["se"][n]["w"]
            sd[f"{bp}squeeze_excite.{n}.bias"] = b["se"][n]["b"]
        sd[bp + "projection.project_conv.weight"] = b["project"]["conv"]["w"]
        sd.update(_bn_state(bp + "projection.project_bn", b["project"]["bn"]))
    sd[pre + "encoder.top_conv.weight"] = p["top"]["conv"]["w"]
    sd.update(_bn_state(pre + "encoder.top_bn", p["top"]["bn"]))
    gen = torch.Generator().manual_seed(2)
    d = p["top"]["bn"]["scale"].shape[0]
    sd["classifier.weight"] = 0.01 * torch.randn((n_labels, d), generator=gen)
    sd["classifier.bias"] = torch.zeros(n_labels)
    return sd


def fairseq_avhubert_state(p: dict) -> dict:
    """An AV-HuBERT tree of the port in the layout of a converted fairseq
    checkpoint (``fuse_ln`` of width 2d and ``post_proj``: concat fuse;
    PReLU trunk) -> ``AVHubertModel`` keys, the positional conv's weight
    norm as g = ||w|| per kernel tap and v = w, plus audio-branch and
    pretraining-head keys that the converter does not read."""
    import torch

    res = "feature_extractor_video.resnet."
    sd = {res + "frontend3D.0.weight": p["stem"]["conv"]["w"],
          **_bn_state(res + "frontend3D.1", p["stem"]["bn"]),
          res + "frontend3D.2.weight": p["stem"]["prelu"]}
    for si, layers in enumerate(p["trunk"]):
        for li, lp in enumerate(layers):
            pre = f"{res}trunk.layer{si + 1}.{li}."
            for ci in range(2):
                sd[f"{pre}conv{ci + 1}.weight"] = lp["convs"][ci]["conv"]["w"]
                sd.update(_bn_state(f"{pre}bn{ci + 1}", lp["convs"][ci]["bn"]))
                sd[f"{pre}relu{ci + 1}.weight"] = lp["prelus"][ci]
            if "shortcut" in lp:
                sd[pre + "downsample.0.weight"] = lp["shortcut"]["conv"]["w"]
                sd.update(_bn_state(pre + "downsample.1", lp["shortcut"]["bn"]))
    sd.update(_hf_lin("feature_extractor_video.proj", p["proj"]))
    sd.update(_hf_ln("layer_norm", p["fuse_ln"]))
    sd.update(_hf_lin("post_extract_proj", p["post_proj"]))
    w = p["pos_conv"]["w"]
    sd["encoder.pos_conv.0.weight_g"] = w.double().square().sum(dim=(0, 1),
                                                                keepdim=True).sqrt().to(w.dtype)
    sd["encoder.pos_conv.0.weight_v"] = w
    sd["encoder.pos_conv.0.bias"] = p["pos_conv"]["b"]
    sd.update(_hf_ln("encoder.layer_norm", p["ln"]))
    for i, b in enumerate(p["blocks"]):
        pre = f"encoder.layers.{i}."
        for ours, fs in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("o", "out_proj")):
            sd.update(_hf_lin(pre + "self_attn." + fs, b["attn"][ours]))
        sd.update(_hf_ln(pre + "self_attn_layer_norm", b["ln1"]))
        sd.update(_hf_lin(pre + "fc1", b["fc1"]))
        sd.update(_hf_lin(pre + "fc2", b["fc2"]))
        sd.update(_hf_ln(pre + "final_layer_norm", b["ln2"]))
    d = p["proj"]["b"].shape[0]
    sd["feature_extractor_audio.proj.weight"] = torch.zeros((d, 104))
    sd["final_proj.weight"] = torch.zeros((256, d))
    sd["mask_emb"] = torch.zeros(d)
    return sd


def write_video_checkpoint(root: Path, enc: str, tree: dict, mc) -> Path:
    """The published layout of a video encoder's weights: a
    ``ResNetForImageClassification`` safetensors directory, an
    ``EfficientNetForImageClassification`` ``pytorch_model.bin`` directory,
    or a fairseq ``.pt`` whose config object's class does not import when
    it is read. Returns the path ``model.video_encoder_path`` names."""
    import types

    import torch

    if enc == "avhubert":
        sd = {k: v.detach().contiguous().cpu() for k, v in fairseq_avhubert_state(tree).items()}
        # a config object of a class from a module that is gone when the
        # file is read (fairseq pickles an OmegaConf config beside the model)
        mod = types.ModuleType("chip_smoke_fairseq_cfg")
        exec("class AVHubertConfig:\n    def __init__(self):\n        self.fuse = 'concat'\n",
             mod.__dict__)
        sys.modules[mod.__name__] = mod
        try:
            path = root / "avhubert_base.pt"
            torch.save({"model": sd, "cfg": mod.AVHubertConfig(), "task_state": {}}, path)
        finally:
            del sys.modules[mod.__name__]
        return path
    d = root / enc
    d.mkdir(parents=True)
    if enc == "resnet":
        r = mc.resnet
        sd = hf_resnet_state(tree)
        cfg = dict(model_type="resnet", architectures=["ResNetForImageClassification"],
                   num_labels=1000, num_channels=3, embedding_size=r.embedding_size,
                   hidden_sizes=list(r.hidden_sizes), depths=list(r.depths),
                   layer_type=r.layer_type, hidden_act="relu",
                   downsample_in_first_stage=r.downsample_in_first_stage)
    else:
        e = mc.efficientnet
        sd = hf_efficientnet_state(tree)
        cfg = dict(model_type="efficientnet",
                   architectures=["EfficientNetForImageClassification"], num_labels=1000,
                   num_channels=3,
                   image_size=e.image_size, width_coefficient=e.width_coefficient,
                   depth_coefficient=e.depth_coefficient, depth_divisor=e.depth_divisor,
                   kernel_sizes=list(e.kernel_sizes), in_channels=list(e.in_channels),
                   out_channels=list(e.out_channels), strides=list(e.strides),
                   num_block_repeats=list(e.num_block_repeats),
                   expand_ratios=list(e.expand_ratios),
                   depthwise_padding=list(e.depthwise_padding),
                   squeeze_expansion_ratio=e.squeeze_expansion_ratio,
                   hidden_dim=e.hidden_dim, hidden_act="swish", batch_norm_eps=1e-3)
    sd = {k: v.detach().contiguous().cpu() for k, v in sd.items()}
    (d / "config.json").write_text(json.dumps(cfg, indent=1))
    if enc == "resnet":
        write_safetensors(d / "model.safetensors", sd)
    else:
        torch.save(sd, d / "pytorch_model.bin")
    return d


def video_weights(enc: str, mc, gen) -> dict:
    """A full-width tree of encoder ``enc`` (f32, on the card) with random
    values on every leaf from ``gen``; AV-HuBERT's in the layout of a
    converted fairseq checkpoint (PReLU trunk, concat fuse head)."""
    import torch

    from avsr_tpu_torch.models.avhubert import init_avhubert
    from avsr_tpu_torch.models.efficientnet import init_efficientnet
    from avsr_tpu_torch.models.layers import dense_init, norm_init
    from avsr_tpu_torch.models.resnet import init_resnet

    if enc == "resnet":
        return jitter(init_resnet(gen, mc.resnet), gen)
    if enc == "efficientnet":
        return jitter(init_efficientnet(gen, mc.efficientnet), gen)
    tree = init_avhubert(gen, mc.avhubert)
    del tree["proj_ln"]
    d = mc.avhubert.d_model
    tree["fuse_ln"] = norm_init(gen, 2 * d)
    tree["post_proj"] = dense_init(gen, 2 * d, d)
    for layers in tree["trunk"]:
        for lp in layers:
            lp["prelus"] = [torch.full((lp["convs"][i]["conv"]["w"].shape[0],), 0.25,
                                       device=gen.device) for i in range(2)]
    return jitter(tree, gen)


def video_traffic(seed: int, size: int):
    """8 requests of 4-10 s synthetic audio and 25 frames of ``size`` px from
    ``seed``, with budgets of 8-16 new tokens."""
    from avsr_tpu_torch.data.dataset import Sample

    rng = np.random.default_rng(seed + 1900)
    samples, budgets = [], []
    for i in range(8):
        ns = int(rng.integers(4 * 16000, 10 * 16000 + 1))
        t = np.arange(ns, dtype=np.float32) / 16000.0
        audio = (0.3 * np.sin(2 * np.pi * rng.uniform(80, 300) * t)
                 + 0.05 * rng.standard_normal(ns)).astype(np.float32)
        frames = rng.integers(0, 256, (25, size, size, 3), dtype=np.uint8)
        samples.append(Sample(f"video/{i}", audio, frames, "", [257]))
        budgets.append(int(rng.integers(8, 17)))
    return samples, budgets


def video_encoder_phase(seed: int) -> dict:
    """Phase 19: ``flagship(video_encoder=...)`` with ResNet-50,
    EfficientNet-b0 and AV-HuBERT-base at full width (see the module
    docstring)."""
    import shutil

    import torch

    from avsr_tpu_torch.cli import common, convert_hf, decode, train
    from avsr_tpu_torch.convert import cast_tree, from_numpy_tree, param_count, to_numpy_tree
    from avsr_tpu_torch.core.config import flagship
    from avsr_tpu_torch.data.loader import featurize
    from avsr_tpu_torch.data.tokenizer import ByteTokenizer
    from avsr_tpu_torch.infer.engine import ServingEngine
    from avsr_tpu_torch.infer.generate import generate_tokens, prepare_params_for_decode
    from avsr_tpu_torch.models.avhubert import avhubert_apply, init_avhubert
    from avsr_tpu_torch.models.avsr import Batch, encode_video, init_avsr_model
    from avsr_tpu_torch.train.state import (cast_frozen, create_train_state, path_leaves,
                                            trainable_mask)
    from avsr_tpu_torch.train.step import make_train_step

    t_all = time.perf_counter()
    res: dict = {"kernel": ssl_kernel_row(seed + 1902, "avhubert", (304, 300),
                                          (300, 287, 256, 300, 17, 199, 260, 1),
                                          (752, 750, "30s"))}
    by_path: dict[str, dict[str, int]] = {}
    nW, nL, nA = 24, 16, 12         # Whisper, LLM and AV-HuBERT layers

    def counted(tag: str, fn):
        torch.cuda.synchronize()
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        by_path[tag] = counts()
        return out

    def want(flash=0, dq=0, dkv=0, int8=0, int4=0) -> dict[str, int]:
        return dict(flash_fwd=flash, flash_bwd_dq=dq, flash_bwd_dkv=dkv, qmatmul_int8=int8,
                    qmatmul_int4=int4)

    def frames_batch(frames, lens=None):
        return Batch(frames=frames, frame_lens=lens)

    tok = ByteTokenizer()
    gen = torch.Generator(device="cuda").manual_seed(seed + 1903)
    work = ROOT / "outputs" / "chip_smoke" / time.strftime("video_%Y%m%d_%H%M%S")
    work.mkdir(parents=True, exist_ok=True)
    bf16, f32 = torch.bfloat16, torch.float32
    try:
        for enc in VIDEO_ENCODERS:
            t_enc = time.perf_counter()
            row: dict = {}
            cfg = flagship(video_encoder=enc)
            mc = cfg.model
            S = mc.image_size
            hb = serving_host_batch(cfg, seed, size=S)
            d = connector_launches("simple", 500, hb.prompt.shape[1], 48, nW, nL)

            # ---- a static bf16 call (B = 8, 10 s, 25 frames, 32 tokens) ---
            params = init_avsr_model(mc, seed=seed, device="cuda", dtype=bf16)
            row["params_b"] = param_count(params) / 1e9
            row["encoder_params_m"] = param_count(params[enc]) / 1e6
            batch = featurize(hb, "cuda", bf16, mc)
            check(tuple(batch.frames.shape) == (8, 25, 3, S, S), f"{enc}: frames "
                  f"{tuple(batch.frames.shape)}")
            kw = dict(max_new_tokens=32, eos_id=-1, compute_dtype=bf16)
            generate_tokens(params, mc, batch, **{**kw, "max_new_tokens": 2})     # warm-up
            torch.cuda.reset_peak_memory_stats()
            st: dict = {}
            out = counted(f"{enc}_generate",
                          lambda: generate_tokens(params, mc, batch, stats=st, **kw))
            peak = torch.cuda.max_memory_allocated() / 1e9
            w = want(*d["generate"].values())
            check(by_path[f"{enc}_generate"] == w,
                  f"{enc}: generate launches {by_path[f'{enc}_generate']}, expected {w}")
            check(out.tokens.shape == (8, 32) and bool((out.lengths == 32).all())
                  and bool(torch.isfinite(st["prefill_logits"]).all()), f"{enc}: the call")
            row["static_bf16"] = dict(
                encode_ms=st["encode_s"] * 1e3, prefill_ms=st["prefill_s"] * 1e3,
                ms_per_token=st["decode_s"] * 1e3 / st["decode_steps"], peak_mem_gb=peak,
                launches=w)
            # the encoder's own forward (bf16, B = 8) at 25 and 100 frames
            row["encoder_ms"] = {}
            for T in (25, 100):
                fr = torch.randn((8, T, 3, S, S), generator=gen, device="cuda").to(bf16)
                with torch.no_grad():
                    row["encoder_ms"][T] = time_ms(lambda: encode_video(
                        params, mc, frames_batch(fr), compute_dtype=bf16, use_kernel="auto",
                        remat=False), 5)
                del fr
            print(f"{enc} static bf16: " + json.dumps(row))

            # ---- a train step of 8 (accum 1) after a warm-up step, and the
            # same two steps again from an identical state -------------------
            tcfg = flagship(["training.grad_accum_steps=1"], video_encoder=enc)
            micro = featurize(train_host_batch(tcfg, tok, np.random.default_rng(seed + 1901),
                                               size=S), "cuda", bf16, mc)
            stacked = _stack([micro])
            ta, tb = cast_frozen(params, mc, bf16), cast_frozen(params, mc, bf16)
            state_a, tr = _run_steps(tcfg, ta, stacked, 2, f"{enc} train", seed,
                                     expect=want(*d["train_step"].values()))
            by_path[f"{enc}_train_2_steps"] = {k: sum(s_["launches"][k] for s_ in tr["steps"])
                                               for k in counts()}
            state_b = create_train_state(tb, tcfg, total_steps=1000)
            step = make_train_step(tcfg)
            m_b = [step(state_b, stacked, seed + i) for i in range(2)]
            for i, s_ in enumerate(tr["steps"]):
                check(s_["loss"] == m_b[i]["loss"] and s_["grad_norm"] == m_b[i]["grad_norm"],
                      f"{enc} train step {i + 1} repeated: {m_b[i]} != {s_}")
            la, lb = path_leaves(state_a.state_dict()), path_leaves(state_b.state_dict())
            diff = [k for k, v in la.items()
                    if isinstance(v, torch.Tensor) and not torch.equal(v, lb[k])]
            check(not diff, f"{enc}: train steps from one state differ in {diff[:5]}")
            row["train_bf16"] = dict(
                step_ms=tr["steps"][-1]["ms"], first_step_ms=tr["steps"][0]["ms"],
                peak_mem_gb=tr["peak_mem_gb"], loss=tr["steps"][-1]["loss"],
                split_ms={k: v for k, v in tr["steps"][-1].items() if k.endswith("_ms")},
                repeated_step_bit_equal=True, launches_per_step=tr["steps"][-1]["launches"])
            print(f"{enc} train bf16: " + json.dumps(row["train_bf16"]))
            del ta, tb, state_a, state_b, step, micro, stacked, la, lb

            # ---- the encoder in f32 on the card (TF32 off) against the same
            # function on the CPU, and bf16 against f32 on the card ----------
            n_fr, lens = (25, [25, 17]) if enc == "avhubert" else (4, None)
            fr = torch.randn((2, n_fr, 3, S, S), generator=gen, device="cuda")
            ln = None if lens is None else torch.tensor(lens, dtype=torch.int32, device="cuda")
            t32 = {enc: cast_tree(params[enc], f32)}
            tcpu = {enc: from_numpy_tree(to_numpy_tree(t32), "cpu")[enc]}
            with torch.no_grad():
                on_card = encode_video(t32, mc, frames_batch(fr, ln), compute_dtype=f32,
                                       use_kernel="auto", remat=False)
                on_cpu = encode_video(tcpu, mc, frames_batch(fr.cpu(), None if ln is None
                                                             else ln.cpu()),
                                      compute_dtype=f32, use_kernel="auto", remat=False)
                half = encode_video(params, mc, frames_batch(fr.to(bf16), ln),
                                    compute_dtype=bf16, use_kernel="auto", remat=False)
            ref = on_cpu
            rel = ((on_card.cpu() - ref).abs().max() / ref.abs().max()).item()
            check(rel <= 1e-4, f"{enc}: f32 on the card vs the CPU max|d| {rel:.3e} x max|ref| "
                               "> 1e-4")
            ratio = ((half.float() - on_card).abs().mean() / on_card.std()).item()
            check(ratio <= 0.1, f"{enc}: bf16 vs f32 mean|d| {ratio:.3e} x std > 0.1")
            row["f32_card_vs_cpu_max_rel"] = rel
            row["bf16_vs_f32_mean_over_std"] = ratio
            print(f"{enc}: f32 card vs CPU max|d|/max|ref| {rel:.3e} (gate 1e-4); bf16 vs f32 "
                  f"mean|d|/std {ratio:.3e} (gate 0.1)")
            del t32, tcpu, on_card, on_cpu, half, fr, params, batch
            settle()

            # ---- f32: the engine (4 slots, 8 requests) == generate_tokens --
            cfg32 = flagship(["runtime.compute_dtype=float32"], video_encoder=enc)
            p32 = prepare_params_for_decode(common.init_or_load_params(
                cfg32, seed=seed, device="cuda"), cfg32.model)
            samples, budgets = video_traffic(seed, S)
            eng = ServingEngine(p32, cfg32, tok, num_slots=4, k_steps=8, seed=seed)
            try:
                run = counted(f"{enc}_engine_f32", lambda: drive_engine(eng, samples, budgets))
                stages = eng.stages_run
            finally:
                eng.close()
            ref_run = static_batches(p32, cfg32, samples, budgets, f32)
            diff = [i for i, (a, b_) in enumerate(zip(run["tokens"], ref_run["tokens"]))
                    if a != b_]
            check(not diff, f"{enc}: f32 engine != generate_tokens for requests {diff}")
            check(by_path[f"{enc}_engine_f32"] == want(flash=(nW + nL) * stages),
                  f"{enc}: f32 engine launches {by_path[f'{enc}_engine_f32']}, {stages} "
                  f"stages")
            row["engine_f32"] = dict(requests=8, slots=4, stages=stages,
                                     tokens_equal_generate_tokens=True,
                                     new_tokens=sum(len(t) for t in run["tokens"]))
            del p32, eng
            settle()

            # ---- the converter on the published layout at full width ------
            tree = video_weights(enc, mc, gen)
            t0 = time.perf_counter()
            path = write_video_checkpoint(work, enc, tree, mc)
            write_s = time.perf_counter() - t0
            gb = (sum(f.stat().st_size for f in path.iterdir()) if path.is_dir()
                  else path.stat().st_size) / 1e9
            ccfg = flagship([f"model.video_encoder_path={path}"], video_encoder=enc)
            t0 = time.perf_counter()
            conv, notes = convert_hf.build_converted_params(ccfg, device="cuda")
            torch.cuda.synchronize()
            conv_s = time.perf_counter() - t0
            check(notes == [enc], f"{enc}: converted {notes}")
            got, want_l = path_leaves(conv[enc]), path_leaves(tree)
            check(got.keys() == want_l.keys(), f"{enc}: converted key paths differ: "
                  f"{sorted(got.keys() ^ want_l.keys())[:5]}")
            for k, v in want_l.items():
                if k == "pos_conv/w":
                    e = (got[k] - v).abs().max().item()
                    check(e <= 1e-5 * v.abs().max().item(), f"{enc}: pos_conv off by {e:.3e}")
                else:
                    check(got[k].dtype == torch.float32 and torch.equal(got[k], v),
                          f"{enc}: converted {k} differs")
            row["convert"] = dict(leaves=len(want_l), gb_read=gb, write_s=write_s,
                                  convert_s=conv_s, s_per_gb_read=conv_s / gb,
                                  layout=path.name)
            print(f"{enc} convert: {len(want_l)} leaves bit-equal, {gb:.3f} GB in "
                  f"{conv_s:.2f} s ({conv_s / gb:.2f} s per GB read)")
            del conv, tree
            settle()
            row["seconds"] = time.perf_counter() - t_enc
            res[enc] = row

        # ---- AV-HuBERT at 300 frames: the flash forward in its 12 blocks ---
        mc = flagship(video_encoder="avhubert").model
        S = mc.image_size
        av = init_avhubert(gen, mc.avhubert, bf16)
        lens300 = torch.tensor([300, 287, 256, 300, 263, 199, 300, 281], dtype=torch.int32,
                               device="cuda")
        fr = torch.randn((8, 300, 3, S, S), generator=gen, device="cuda")
        with torch.no_grad():
            o16 = counted("avhubert_300_encode", lambda: avhubert_apply(
                av, fr.to(bf16), mc.avhubert, frame_lengths=lens300, compute_dtype=bf16))
            check(by_path["avhubert_300_encode"] == want(flash=nA),
                  f"avhubert at 300 frames: launches {by_path['avhubert_300_encode']}")
            av32 = cast_tree(av, f32)
            k32 = avhubert_apply(av32, fr, mc.avhubert, frame_lengths=lens300,
                                 compute_dtype=f32)
            p32_ = avhubert_apply(av32, fr, mc.avhubert, frame_lengths=lens300,
                                  compute_dtype=f32, use_kernel="never")
        valid = torch.arange(300, device="cuda")[None, :] < lens300[:, None]
        e300 = ((k32 - p32_).abs()[valid].max() / p32_.abs()[valid].max()).item()
        check(e300 <= 1e-4 and bool(torch.isfinite(o16.float()).all()),
              f"avhubert at 300 frames: f32 kernel path vs mha_reference {e300:.3e} x max|ref|")
        res["avhubert_300"] = dict(frames=300, rows=304, lens=lens300.tolist(),
                                   launches_per_encode=by_path["avhubert_300_encode"]["flash_fwd"],
                                   f32_kernel_vs_plain_max_rel=e300)
        print(f"avhubert at 300 frames: {nA} flash launches per encode; f32 kernel path vs "
              f"mha_reference max|d|/max|ref| {e300:.3e} (gate 1e-4)")
        del av, av32, fr, o16, k32, p32_
        settle()

        # one step with model.finetune_avhubert_layers=[10, 11] at 300 frames:
        # the video branch runs with grad; blocks 10-11 (and their remat
        # recompute) launch forward, dQ and dK/dV
        tuned = (10, 11)
        fcfg = flagship(["training.grad_accum_steps=1", "model.finetune_avhubert_layers=10,11",
                         "data.video_buckets=25,50,100,300", "data.max_video_length=300"],
                        video_encoder="avhubert")
        fm = fcfg.model
        params = init_avsr_model(fm, seed=seed, device="cuda", dtype=bf16)
        micro = featurize(train_host_batch(fcfg, tok, np.random.default_rng(seed + 1904),
                                           n_frames=300, size=S), "cuda", bf16, fm)
        check(tuple(micro.frames.shape[:2]) == (8, 300), f"finetune frames "
              f"{tuple(micro.frames.shape)}")
        stacked = _stack([micro])
        ta, tb = cast_frozen(params, fm, bf16), cast_frozen(params, fm, bf16)
        before = {k: v.clone() for k, v in path_leaves(ta["avhubert"]).items()}
        w = want(flash=nW + nA + len(tuned) + 2 * nL, dq=len(tuned) + nL, dkv=len(tuned) + nL)
        state_a, tr = _run_steps(fcfg, ta, stacked, 2, "avhubert finetune", seed, expect=w)
        by_path["avhubert_finetune_2_steps"] = {
            k: sum(s_["launches"][k] for s_ in tr["steps"]) for k in counts()}
        state_b = create_train_state(tb, fcfg, total_steps=1000)
        step = make_train_step(fcfg)
        m_b = [step(state_b, stacked, seed + i) for i in range(2)]
        for i, s_ in enumerate(tr["steps"]):
            check(s_["loss"] == m_b[i]["loss"] and s_["grad_norm"] == m_b[i]["grad_norm"],
                  f"avhubert finetune step {i + 1} repeated: {m_b[i]} != {s_}")
        la, lb = path_leaves(state_a.state_dict()), path_leaves(state_b.state_dict())
        diff = [k for k, v in la.items()
                if isinstance(v, torch.Tensor) and not torch.equal(v, lb[k])]
        check(not diff, f"avhubert finetune: steps from one state differ in {diff[:5]}")
        after = path_leaves(state_a.params["avhubert"])
        mask = path_leaves(trainable_mask(ta, fm)["avhubert"])
        moved = sorted(k for k, v in after.items() if not torch.equal(v, before[k]))
        check(moved and all(k.split("/")[:2] in (["blocks", "10"], ["blocks", "11"])
                            for k in moved),
              f"avhubert finetune: moved leaves outside blocks 10-11: {moved[:5]}")
        check(all(k in moved for k in mask if mask[k] and k.endswith("/w")),
              "avhubert finetune: a tuned weight did not move")
        res["avhubert_finetune"] = dict(
            tuned=list(tuned), frames=300, moved_leaves=len(moved),
            step_ms=tr["steps"][-1]["ms"], first_step_ms=tr["steps"][0]["ms"],
            peak_mem_gb=tr["peak_mem_gb"], launches_per_step=tr["steps"][-1]["launches"],
            repeated_step_bit_equal=True)
        print("avhubert finetune [10, 11] at 300 frames: " + json.dumps(res["avhubert_finetune"]))
        del params, micro, stacked, ta, tb, state_a, state_b, step, la, lb, before, after
        settle()

        # ---- the train and decode CLIs with AV-HuBERT on the corpus, with
        # the compact link (88 px frames, AV-HuBERT's statistics, YUV420) --
        corpus = make_corpus(work, seed)
        flag = ["--seed", str(seed), "--device", "cuda", *FLAGSHIP_OVERRIDES,
                "data.synthetic=false", f"data.path={corpus}", "data.num_workers=4",
                "data.compact_transfer=true", "model.video_encoder=avhubert"]
        run_dir = work / "run"

        def train_run():
            rc = train.main([*flag, "training.grad_accum_steps=1", "training.max_steps=2",
                             "training.save_every_steps=0", f"training.checkpoint_dir={run_dir}"])
            check(rc == 0, f"train CLI (avhubert) returned {rc}")
            rows_ = loss_rows(run_dir)
            tr_ = [r for r in rows_ if r[2] == "train"]
            check(len(tr_) == 2 and all(np.isfinite(float(r[3])) for r in tr_),
                  f"avhubert train rows {tr_}")
            return [float(r[3]) for r in tr_]

        losses = counted("avhubert_train_cli", train_run)
        w = want(flash=2 * (nW + 2 * nL) + 2 * (nW + nL), dq=2 * nL, dkv=2 * nL)
        check(by_path["avhubert_train_cli"] == w,
              f"avhubert train CLI launches {by_path['avhubert_train_cli']}, expected {w}")

        def decode_run():
            out_dir = work / "dec"
            rc = decode.main([*flag, "decode.max_new_tokens=32", f"decode.output_dir={out_dir}",
                              "--checkpoint", str(run_dir / "ckpt"), "--split", "test"])
            check(rc == 0, f"decode CLI (avhubert) returned {rc}")
            (res_f,), (wer_f,) = out_dir.glob("results_*.txt"), out_dir.glob("wer_*.txt")
            check(res_f.read_text().count("UTT: ") == 12
                  and "utterances: 12\n" in wer_f.read_text(),
                  "avhubert decode: the test split's 12 utterances were not each scored once")
            m = re.search(r"WER: ([0-9.]+)", wer_f.read_text())
            check(m is not None and np.isfinite(float(m.group(1))), "avhubert decode: no WER")
            return float(m.group(1))

        wer = counted("avhubert_decode_cli", decode_run)
        check(by_path["avhubert_decode_cli"] == want(flash=2 * (nW + nL)),
              f"avhubert decode CLI launches {by_path['avhubert_decode_cli']}")
        res["cli_avhubert"] = dict(train_losses=losses, test_wer=wer, compact_transfer=True)
        print(f"avhubert CLIs on the corpus (compact link): losses {losses}, test WER {wer}")

        # ---- the serving preset with ResNet --------------------------------
        pcfg = flagship(list(PRESET_OVERRIDES), video_encoder="resnet")
        pp = common.load_decode_params(pcfg, seed=seed, device="cuda")
        batch = featurize(serving_host_batch(pcfg, seed), "cuda", bf16, pcfg.model)
        kq = dict(max_new_tokens=32, eos_id=-1, compute_dtype=bf16, kv_cache_dtype="int8")
        generate_tokens(pp, pcfg.model, batch, **{**kq, "max_new_tokens": 2})   # warm-up
        torch.cuda.reset_peak_memory_stats()
        stq: dict = {}
        outq = counted("resnet_preset_generate",
                       lambda: generate_tokens(pp, pcfg.model, batch, stats=stq, **kq))
        steps = stq["decode_steps"]
        w = want(flash=nW + nL, int8=steps + 1, int4=4 * nL * steps)
        check(by_path["resnet_preset_generate"] == w,
              f"resnet preset launches {by_path['resnet_preset_generate']}, expected {w}")
        check(outq.tokens.shape == (8, 32) and bool(torch.isfinite(stq["prefill_logits"]).all()),
              "resnet preset tokens or logits")
        res["resnet_preset"] = dict(
            encode_ms=stq["encode_s"] * 1e3, prefill_ms=stq["prefill_s"] * 1e3,
            ms_per_token=stq["decode_s"] * 1e3 / steps,
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, launches=w)
        print("resnet preset: " + json.dumps(res["resnet_preset"]))
        del pp, batch
        settle()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    res["launches_by_path"] = by_path
    res["seconds"] = time.perf_counter() - t_all
    print(f"video encoder phase: {res['seconds']:.1f} s; launches " + json.dumps(by_path))
    return res


# ---------------------------------------------------------------------------
# Tooling phase
# ---------------------------------------------------------------------------

def tooling_phase(seed: int) -> dict:
    """Phase 20: the validate, analyze_memory and profile CLIs at full width
    on the flagship (see the module docstring)."""
    import shutil

    import torch

    from avsr_tpu_torch.cli import analyze_memory, profile, validate
    from avsr_tpu_torch.cli.common import init_params
    from avsr_tpu_torch.core.config import flagship
    from avsr_tpu_torch.train.checkpoint import export_params
    from avsr_tpu_torch.train.state import path_leaves, tree_leaves

    t_all = time.perf_counter()
    work = ROOT / "outputs" / "chip_smoke" / time.strftime("tooling_%Y%m%d_%H%M%S")
    flag = list(FLAGSHIP_OVERRIDES)
    cli = ["--seed", str(seed), "--device", "cuda"]
    nW, nL = 24, 16                 # Whisper and LLM layers
    by_path: dict[str, dict[str, int]] = {}
    res: dict = {"profiles": {}}

    def want(flash=0, dq=0, dkv=0, int8=0, int4=0) -> dict[str, int]:
        return dict(flash_fwd=flash, flash_bwd_dq=dq, flash_bwd_dkv=dkv, qmatmul_int8=int8,
                    qmatmul_int4=int4)

    def times(w: dict[str, int], n: int) -> dict[str, int]:
        return {k: v * n for k, v in w.items()}

    def run(tag: str, main, argv: list[str]) -> int:
        """One CLI call with the launch counts set to 0 just before it and
        read just after it."""
        torch.cuda.synchronize()
        reset_counts()
        try:
            return main(argv)
        finally:
            torch.cuda.synchronize()
            by_path[tag] = counts()

    rec = _Records()
    logging.getLogger("avsr_tpu_torch").addHandler(rec)
    try:
        # ---- validate: the gate passes, then fires on a NaN leaf ------------
        t0 = time.perf_counter()
        rc = run("validate", validate.main, cli + ["--synthetic", "--num_batches", "2", *flag])
        check(rc == 0, f"validate CLI returned {rc} on the flagship")
        w = want(flash=2 * (nW + nL))           # per eval batch: 24 Whisper + 16 LLM
        check(by_path["validate"] == w, f"validate launches {by_path['validate']}, expected {w}")
        losses = [a[1] for a in rec.args("batch ")]
        check(len(losses) == 2 and all(np.isfinite(losses)), f"validate losses {losses}")
        res["validate"] = dict(losses=losses, seconds=time.perf_counter() - t0)

        params = init_params(flagship(), seed=seed, device="cuda")
        lora = next(k for k in path_leaves(params) if "lora" in k)
        path_leaves(params)[lora].fill_(float("nan"))
        export_params(params, work / "poisoned")
        del params
        settle()
        poisoned = cli + ["--synthetic", "--num_batches", "1", "--checkpoint",
                          str(work / "poisoned"), *flag]
        rc = run("validate_poisoned", validate.main, poisoned)
        check(rc == 1, f"validate CLI returned {rc} with {lora} set to NaN, not 1")
        raised = None
        try:
            run("validate_poisoned_checkify", validate.main, poisoned[:-len(flag)]
                + ["--checkify", *flag])
        except FloatingPointError as e:
            raised = str(e)
        check(raised is not None and "NaN loss in the eval step" in raised,
              f"validate --checkify with a NaN leaf raised {raised!r}")
        for tag in ("validate_poisoned", "validate_poisoned_checkify"):
            check(by_path[tag] == want(flash=nW + nL), f"{tag} launches {by_path[tag]}")
        res["validate"].update(poisoned_leaf=lora, poisoned_rc=rc, checkify_raised=raised)
        print("tooling validate: " + json.dumps(res["validate"]))
        shutil.rmtree(work / "poisoned", ignore_errors=True)
        settle()

        # ---- analyze_memory ------------------------------------------------
        t0 = time.perf_counter()
        rc = run("analyze_memory", analyze_memory.main,
                 cli + ["--output_dir", str(work / "memory"), *flag])
        check(rc == 0, f"analyze_memory CLI returned {rc}")
        mem = json.loads((work / "memory" / "memory_stats.json").read_text())
        shapes = analyze_memory.shape_tree(flagship())
        check(set(mem["measured_fp32"]) == set(shapes), "analyze_memory components")
        for name, row in mem["measured_fp32"].items():
            logical = sum(x.numel() * x.element_size() for x in tree_leaves(shapes[name]))
            check(row["allocator_delta"] >= row["on_device"] >= logical > 0,
                  f"analyze_memory {name}: {row}, logical {logical}")
            row["logical"] = logical
        check(mem["device_memory"] and all(isinstance(v, int)
                                           for v in mem["device_memory"].values()),
              "analyze_memory device_memory")
        res["analyze_memory"] = dict(
            totals_gib={m: v["total_gib"] for m, v in mem["modes"].items()},
            params_total=mem["params_total"], params_trainable=mem["params_trainable"],
            measured=mem["measured_fp32"], seconds=time.perf_counter() - t0)
        print("tooling analyze_memory: " + json.dumps(res["analyze_memory"]))
        settle()

        # ---- profile: train (the largest buckets, B = 8) and decode ---------
        # (the preset's decode is not profiled: its int4 and int8 launches
        # are checked exactly by the preset CLI phase and phases 22-24)
        for tag, mode, steps, over, per_step in (
                ("profile_train", "train", 2, [],
                 want(flash=nW + 2 * nL, dq=nL, dkv=nL)),     # remat: the LLM twice
                ("profile_decode", "decode", 1, ["decode.max_new_tokens=32"],
                 want(flash=nW + nL))):
            out = work / tag
            n_logged = len(rec.args("kernel launches"))
            rc = run(tag, profile.main, cli + ["--mode", mode, "--steps", str(steps),
                                               "--output_dir", str(out), *flag, *over])
            check(rc == 0, f"profile CLI ({tag}) returned {rc}")
            traced_counts = rec.args("kernel launches")[n_logged:]
            check(len(traced_counts) == 1, f"{tag}: the counters' log line")
            counters = traced_counts[0]
            report = json.loads((out / "profile_report.json").read_text())
            in_trace = report["kernels_in_trace"]       # the CLI's one read of the trace
            check(counters == in_trace == times(per_step, steps),
                  f"{tag}: kernels in the trace {in_trace}, the wrappers' counters "
                  f"{counters}, expected {times(per_step, steps)}")
            check(by_path[tag] == times(per_step, steps + 1),     # + the warm-up step
                  f"{tag}: launches {by_path[tag]}, expected {times(per_step, steps + 1)}")
            check(report["device_busy_ms"] > 0 and report["planes"][0].startswith("GPU"),
                  f"{tag}: no device time in the trace: {report['planes']}")
            summary = {k: report[k] for k in (
                "device_busy_ms", "async_dma_ms", "trace_span_ms", "device_duty_cycle",
                "loop_ms", "prefix_ms", "wall_s", "steps", "planes")}
            summary.update(kernels_in_trace=in_trace, by_category=report["by_category"][:8],
                           by_scope=report["by_scope"][:10], top_ops=report["top_ops"][:6])
            res["profiles"][tag] = summary
            print(f"tooling {tag}: busy {report['device_busy_ms']} ms over a span of "
                  f"{report['trace_span_ms']} ms (duty cycle "
                  f"{report['device_duty_cycle']}), loop {report['loop_ms']} ms, prefix "
                  f"{report['prefix_ms']} ms, {steps} step(s) in {report['wall_s']} s")
            print(f"tooling {tag} by_category: " + json.dumps(report["by_category"][:8]))
            print(f"tooling {tag} by_scope: " + json.dumps(report["by_scope"][:10]))
            print(f"tooling {tag} top_ops: " + json.dumps(report["top_ops"][:6]))
            settle()
    finally:
        logging.getLogger("avsr_tpu_torch").removeHandler(rec)
        shutil.rmtree(work, ignore_errors=True)
    res["launches_by_path"] = {f"tooling_{k}": v for k, v in by_path.items()}
    res["seconds"] = time.perf_counter() - t_all
    print(f"tooling phase: {res['seconds']:.1f} s; launches " + json.dumps(by_path))
    return res


# ---------------------------------------------------------------------------
# Phase 21: data parallelism and fsdp across processes
# ---------------------------------------------------------------------------

# the train runs of phase 21: name, global batch, compute dtype, mesh, steps
# (the first of the two bf16 steps warms up; the f32 gates hold after one
# step, which keeps the script within its time limit)
# Phase 21 runs the flagship's widths at a quarter of its depth (6 of 24
# Whisper, 3 of 12 CLIP and 4 of 16 LLM blocks): over gloo its steps,
# gathers and checkpoints scale with the depth, and phase 22 drives the
# full depth across processes, so the script keeps within its time limit
MESH_DEPTH = ("model.whisper.n_layers=6", "model.clip.n_layers=3", "model.llm.n_layers=4")
MESH_TRAIN = (("f32_dp2", 4, "float32", ("mesh.dp=2", *MESH_DEPTH), 1),
              ("f32_fsdp2", 4, "float32", ("mesh.dp=1", "mesh.fsdp=2", *MESH_DEPTH), 1),
              ("bf16_dp2", 8, "bfloat16", ("mesh.dp=2", *MESH_DEPTH), 2),
              ("bf16_fsdp2", 8, "bfloat16", ("mesh.dp=1", "mesh.fsdp=2", *MESH_DEPTH), 2))
MESH_SEED = 2100
MESH_DECODES = (("f32", ("runtime.compute_dtype=float32",), 8),
                ("bf16", (), 4),
                ("preset", PRESET_OVERRIDES, 4))
MESH_RANK_TIMEOUT_S = 900
# tokens of the decode CLI's calls in phases 21 and 22, and the train CLI's
# global batch there, small enough for the script's time limit
MESH_DECODE_TOKENS = 16
MESH_CLI_BATCH = 2


def mesh_leaves(cfg) -> tuple[str, ...]:
    """The leaves phases 21-25 hold to one process: two LoRA ``b`` (layer
    0's q and the last layer's o), and with the ``moe`` connector its first
    block's expert w1 (sliced over ep) and router."""
    lora = ("llm/layers/0/q/lora/b", f"llm/layers/{cfg.model.llm.n_layers - 1}/o/lora/b")
    if cfg.model.connector_type != "moe":
        return lora
    return (*lora, "audio_connector/blocks/0/experts/w1", "audio_connector/blocks/0/router/w")


def mesh_cfg(dtype: str, mesh: tuple[str, ...] = ()):
    """The flagship's train config of phase 21: accum 1 (a global batch of
    4 splits into 2 rows a rank), LoRA dropout on, the full learning rate
    from the second step on."""
    from avsr_tpu_torch.core.config import flagship

    return flagship(["training.grad_accum_steps=1", "training.warmup_steps=1",
                     f"runtime.compute_dtype={dtype}", *mesh])


def mesh_params(cfg, seed: int):
    """Random flagship weights from ``seed`` (LoRA b perturbed), frozen
    leaves in the compute dtype: the same tree in every process."""
    import torch

    from avsr_tpu_torch.models.avsr import init_avsr_model
    from avsr_tpu_torch.train.state import cast_frozen

    params = init_avsr_model(cfg.model, seed=seed, device="cuda", dtype=torch.float32)
    _perturb_lora_b(params, torch.Generator(device="cuda").manual_seed(seed + 1))
    return cast_frozen(params, cfg.model, getattr(torch, cfg.runtime.compute_dtype))


def mesh_batch(cfg, B: int, seed: int, bucket: tuple[int, int] = (3000, 100)):
    """A global train batch [1, B, ...] at the ``bucket`` of (mel frames,
    video frames), by default the largest (3000, 100), ragged lengths (from
    2/3 of the bucket up) and 10-48 label tokens, made on the card from
    ``seed``: the same in every process."""
    import torch

    from avsr_tpu_torch.data.tokenizer import ByteTokenizer
    from avsr_tpu_torch.models.avsr import Batch
    from avsr_tpu_torch.train.step import microbatch

    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, cfg.runtime.compute_dtype)
    m = cfg.model

    def ints(lo: int, hi: int, shape) -> torch.Tensor:
        return torch.randint(lo, hi, shape, generator=g, device="cuda", dtype=torch.int32)

    prompt = ByteTokenizer().encode(m.prompt, add_bos=True)
    T, F = bucket
    return microbatch(Batch(
        mel=torch.randn((B, m.whisper.n_mels, T), generator=g, device="cuda"),
        mel_lens=ints(2 * T // 3, T + 1, (B,)),
        frames=torch.randn((B, F, 3, m.image_size, m.image_size), generator=g,
                           device="cuda").to(dt),
        frame_lens=ints(3 * F // 5, F + 1, (B,)),
        prompt_tokens=torch.tensor(prompt, dtype=torch.int32, device="cuda")[None].expand(B, -1),
        labels=ints(0, min(1000, m.llm.vocab_size), (B, 48)), label_lens=ints(10, 49, (B,))), 1)


def mesh_train_run(B: int, dtype: str, mesh_over: tuple, n: int, mesh=None,
                   bucket: tuple[int, int] = (3000, 100)) -> dict:
    """One run of ``MESH_TRAIN`` (or phases 22-25's): ``n`` steps on this
    rank's rows (all rows without a mesh) at ``bucket`` (``mesh_batch``),
    each timed; the metrics, the step ms, the peak memory, the watched
    leaves (gathered whole), the shapes this rank holds of the expert
    leaves and the MoE assignments its routings dropped."""
    import torch

    from avsr_tpu_torch.mesh import sharding
    from avsr_tpu_torch.mesh.multihost import local_rows
    from avsr_tpu_torch.models.avsr import Batch
    from avsr_tpu_torch.ops import moe
    from avsr_tpu_torch.train.state import create_train_state, path_leaves
    from avsr_tpu_torch.train.step import make_train_step

    cfg = mesh_cfg(dtype, mesh_over)
    params = mesh_params(cfg, MESH_SEED)
    if mesh is not None:
        params = sharding.shard_params(params, mesh)
    state = create_train_state(params, cfg, total_steps=1000)
    del params
    step = make_train_step(cfg, mesh)
    batch = mesh_batch(cfg, B, MESH_SEED, bucket)
    if mesh is not None:
        lo, hi = local_rows(B, (mesh.data.rank, mesh.ways))
        batch = Batch(*[None if x is None else x[:, lo:hi] for x in batch])
    settle()
    torch.cuda.reset_peak_memory_stats()
    metrics, ms = [], []
    route, dropped = moe.route, []

    def counted(logits, valid, topk, C, **kw):     # assignments past capacity (device sums)
        out = route(logits, valid, topk, C, **kw)
        dropped.append(valid.sum() * topk - out[0].sum())
        return out

    moe.route = counted
    try:
        for i in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics.append(step(state, batch, MESH_SEED + i))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        moe.route = route
    leaves = path_leaves(state.params)
    with torch.no_grad():
        watched = {k: sharding.gather_leaf(leaves[k]).float().cpu() for k in mesh_leaves(cfg)}
    res = dict(metrics=metrics, step_ms=ms, peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               rows=batch.labels.shape[1], leaves=watched,
               experts={k: list(v.shape) for k, v in leaves.items() if "/experts/" in k},
               moe_dropped=int(sum(dropped).item()) if dropped else 0)
    del state, batch
    settle()
    return res


def mesh_worker(pool_dir: str) -> int:
    """One rank of phases 21-24 (``python3 chip_smoke.py --mesh-worker
    DIR``, with torchrun's environment), kept for every job of its pool
    (``spawn_ranks``): it joins the process group and asks the backend for
    every collective once, then runs each job that appears in ``DIR``
    (``job{n}.json``, in order; ``stop`` ends it): the job's runs in order,
    each with the launch counts set to 0 just before it; writes what each
    run returned and launched, and rank 0 the watched leaves."""
    import importlib

    import torch

    from avsr_tpu_torch.mesh import multihost, sharding

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pool = Path(pool_dir)
    device, backend = multihost.init_distributed("cuda")
    rank, world = multihost.process_shard()
    takes = _probe_backend(device)
    for n in itertools.count():
        path = pool / f"job{n}.json"
        while not path.exists():
            if (pool / "stop").exists():
                return 0
            time.sleep(0.1)
        job = json.loads(path.read_text())
        out: dict = dict(rank=rank, world=world, device=str(device),
                         card=torch.cuda.get_device_name(device), backend=backend,
                         runs={}, backend_takes=takes)
        leaves = {}
        for run in job["runs"]:
            reset_counts()
            t0 = time.perf_counter()
            if run["kind"] == "train":
                cfg = mesh_cfg(run["dtype"], tuple(run["mesh"]))
                mesh = sharding.build_mesh(cfg.mesh, world=world, rank=rank)
                res = mesh_train_run(run["B"], run["dtype"], tuple(run["mesh"]), run["steps"],
                                     mesh, tuple(run.get("bucket", (3000, 100))))
                leaves[run["name"]] = res.pop("leaves")
                res.update(mesh=mesh.shape, sp_rank=mesh.sp.rank, pp_rank=mesh.pp.rank)
            elif run["kind"] == "decode":
                from avsr_tpu_torch.core.config import flagship
                from avsr_tpu_torch.ops import attention as A

                cfg = flagship([*run["over"], *run["mesh"]])
                mesh = sharding.build_mesh(cfg.mesh, world=world, rank=rank)
                rings = A.ring_dispatch_count
                A._ring_fallback_warned.clear()
                res = tp_decode_run(tuple(run["over"]), run["seed"], mesh)
                torch.save({k: res.pop(k) for k in ("tokens", "logits")},
                           job["decodes"].format(name=run["name"], rank=rank))
                res.update(mesh=mesh.shape, rings=A.ring_dispatch_count - rings,
                           fallbacks=sorted(A._ring_fallback_warned))
            elif run["kind"] == "ring":
                from avsr_tpu_torch.core.config import flagship

                mesh = sharding.build_mesh(flagship(run["mesh"]).mesh, world=world, rank=rank)
                res = dict(rows=sp_ring_rows(mesh, run["seed"]))
            else:
                res = _timed_cli(importlib.import_module(f"avsr_tpu_torch.cli.{run['cli']}"),
                                 run["argv"])
            torch.cuda.synchronize()
            res.update(seconds=time.perf_counter() - t0, launches=counts())
            out["runs"][run["name"]] = res
            settle()
        if rank == 0:
            torch.save(leaves, job["leaves"])
        target = Path(job["out"].format(rank=rank))
        target.with_suffix(".tmp").write_text(json.dumps(out))
        target.with_suffix(".tmp").rename(target)


def _probe_backend(device) -> dict[str, str]:
    """Whether the process group's backend takes each collective of
    ``mesh/collectives.py::BACKEND_TABLE`` on CUDA tensors of each dtype it
    moves, the tp operators included ("yes", or the error). Every rank
    makes the same calls in order."""
    from avsr_tpu_torch.mesh.collectives import probe_backend

    return probe_backend(device)


def _timed_cli(mod, argv: list[str]) -> dict:
    """A CLI's ``main(argv)``; for the decode CLI also the seconds of its
    decode loop (``run_protocol``, after the weights are made)."""
    import torch

    res: dict = {}
    proto = getattr(mod, "run_protocol", None)
    if proto is not None:
        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return proto(*a, **kw)
            finally:
                torch.cuda.synchronize()
                res["protocol_s"] = time.perf_counter() - t0
        mod.run_protocol = timed
    try:
        res["rc"] = mod.main(argv)
    finally:
        if proto is not None:
            mod.run_protocol = proto
    return res


# the rank processes of phases 21-24, one pool per (world, sharing card 0),
# started at a pool's first job and kept until ``close_pools``
_POOLS: dict[tuple[int, bool], dict] = {}


def _pool(world: int, shared_card: bool) -> dict:
    """The pool of ``world`` rank processes (``--mesh-worker``) with
    torchrun's environment on a free localhost port: all on card 0 over
    gloo (``shared_card``), or one card each over NCCL; started here once."""
    import socket

    key = (world, shared_card)
    if key in _POOLS:
        return _POOLS[key]
    d = ROOT / "outputs" / "chip_smoke" / time.strftime(
        f"pool{world}{'s' if shared_card else 'n'}_%Y%m%d_%H%M%S")
    d.mkdir(parents=True, exist_ok=True)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port))
    if shared_card:
        env.update(LOCAL_WORLD_SIZE=str(world), CUDA_VISIBLE_DEVICES="0")
    logs = [d / f"rank{r}.log" for r in range(world)]
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-worker",
                               str(d)], cwd=ROOT, stdout=open(logs[r], "w"),
                              stderr=subprocess.STDOUT,
                              env={**env, "RANK": str(r), "LOCAL_RANK": str(r)})
             for r in range(world)]
    _POOLS[key] = dict(dir=d, procs=procs, logs=logs, jobs=0)
    return _POOLS[key]


def close_pools() -> None:
    """Stops every pool's ranks (after their current job) and removes its
    directory; a rank that does not stop within 60 s is killed."""
    import shutil

    for pool in _POOLS.values():
        (pool["dir"] / "stop").write_text("")
        for p in pool["procs"]:
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        shutil.rmtree(pool["dir"], ignore_errors=True)
    _POOLS.clear()


def spawn_ranks(job: dict, work: Path, world: int, shared_card: bool) -> list[dict]:
    """Runs ``job`` on the pool of ``world`` rank processes (started at the
    first job; all on card 0 over gloo with ``shared_card``, else one card
    each over NCCL). Waits for each rank's report with a timeout; a rank
    that fails (or the timeout) stops the pool and fails the phase. Returns
    each rank's report."""
    tag = job["tag"]
    job = dict(job, out=str(work / f"{tag}_rank{{rank}}.json"),
               leaves=str(work / f"{tag}_leaves.pt"),
               decodes=str(work / f"{tag}_{{name}}_rank{{rank}}.pt"))
    pool = _pool(world, shared_card)
    path = pool["dir"] / f"job{pool['jobs']}.json"
    path.with_suffix(".tmp").write_text(json.dumps(job))
    path.with_suffix(".tmp").rename(path)
    pool["jobs"] += 1
    procs, logs = pool["procs"], pool["logs"]
    outs = [Path(job["out"].format(rank=r)) for r in range(world)]
    t0 = time.perf_counter()
    while not all(o.exists() for o in outs):
        failed = [r for r, p in enumerate(procs) if p.poll() is not None]
        late = time.perf_counter() - t0 > MESH_RANK_TIMEOUT_S
        if failed or late:
            tails = "\n".join(f"--- rank {r}:\n{logs[r].read_text()[-3000:]}"
                              for r in (failed or range(world)))
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            check(False, f"{tag}: rank(s) {failed or 'all'} "
                         f"{'failed' if failed else 'timed out'}\n{tails}")
        time.sleep(0.2)
    print(f"mesh {tag}: {world} ranks in {time.perf_counter() - t0:.1f} s")
    return [json.loads(o.read_text()) for o in outs]


def hyp_lines(out_dir: Path) -> list[str]:
    (results,) = out_dir.glob("results_*.txt")
    return [ln for ln in results.read_text().splitlines() if ln.startswith("HYP:")]


def mesh_phase(seed: int) -> dict:
    """Phase 21: the train and decode CLIs and the train step across
    processes, one process per rank, at full width on the flagship cut to
    ``MESH_DEPTH`` (see the module docstring)."""
    import shutil

    import torch

    from avsr_tpu_torch.cli import decode, train

    t_all = time.perf_counter()
    work = ROOT / "outputs" / "chip_smoke" / time.strftime("mesh_%Y%m%d_%H%M%S")
    work.mkdir(parents=True, exist_ok=True)
    flag = [*FLAGSHIP_OVERRIDES, *MESH_DEPTH]
    cli = ["--seed", str(seed), "--device", "cuda"]
    cards = torch.cuda.device_count()
    print(f"mesh phase ({' '.join(MESH_DEPTH)}): 2 ranks sharing card 0 over gloo"
          + (f"; 2 ranks on 2 of the {cards} cards over NCCL" if cards >= 2 else
             " (one card: no NCCL run)"))
    res: dict = {"train": {}, "train_cli": {}, "decode": {}, "launches_by_path": {}}

    def train_over(run_dir: Path, steps: int, *extra: str) -> list[str]:
        return [*cli, *flag, "data.synthetic=true", "data.synthetic_size=10",
                "training.grad_accum_steps=1", "training.save_every_steps=0",
                f"data.batch_size={MESH_CLI_BATCH}", "runtime.compute_dtype=float32",
                f"training.max_steps={steps}", f"training.checkpoint_dir={run_dir}", *extra]

    def dec_over(tag: str, extra: tuple, B: int) -> list[str]:
        return [*cli, *flag, "data.synthetic=true", "data.synthetic_size=40",
                f"decode.max_new_tokens={MESH_DECODE_TOKENS}", f"decode.batch_size={B}",
                f"decode.output_dir={work / tag}", *extra]

    def one_card(tag: str, mod, argv: list[str]) -> dict:
        torch.cuda.synchronize()
        reset_counts()
        out = _timed_cli(mod, argv)
        torch.cuda.synchronize()
        check(out["rc"] == 0, f"{tag} returned {out['rc']}")
        res["launches_by_path"][f"mesh_{tag}"] = counts()
        return out

    try:
        # ---- one process: the references -----------------------------------
        ref = {}
        for _, B, dtype, _, n in MESH_TRAIN[::2]:    # one per dtype
            reset_counts()
            ref[dtype] = mesh_train_run(B, dtype, MESH_DEPTH, n)
            res["launches_by_path"][f"mesh_train_{dtype}_one_card"] = counts()
            settle()
        ones = {}
        for tag, extra, B in MESH_DECODES:
            ones[tag] = one_card(f"decode_{tag}_one_card", decode, dec_over(
                f"dec1_{tag}", extra, B))
            settle()
        one_run = work / "train_one"
        ones["train"] = one_card("train_cli_one_card", train, train_over(one_run, 2))
        shutil.rmtree(one_run / "ckpt", ignore_errors=True)
        settle()

        # ---- 2 ranks on card 0 (gloo), and on 2 cards (NCCL) -----------------
        def rank_runs(group: str) -> list[dict]:
            runs = [dict(kind="train", name=n, B=B, dtype=d, mesh=list(m), steps=k)
                    for n, B, d, m, k in MESH_TRAIN]
            runs.append(dict(kind="cli", name="train_cli", cli="train", argv=train_over(
                work / f"train_{group}", 1, "mesh.dp=1", "mesh.fsdp=2")))
            return runs + [dict(kind="cli", name=f"decode_{tag}", cli="decode",
                                argv=dec_over(f"dec2_{group}_{tag}", extra, 8))
                           for tag, extra, _ in MESH_DECODES]

        reports = {"gloo": spawn_ranks(dict(tag="gloo", runs=rank_runs("gloo")), work, 2, True)}
        if cards >= 2:
            reports["nccl"] = spawn_ranks(dict(tag="nccl", runs=rank_runs("nccl")), work, 2, False)

        # ---- the train steps: each mesh against one process -----------------
        for group, reps in reports.items():
            check(reps[0]["backend"] == group, f"{group} ranks ran {reps[0]['backend']}")
            takes = reps[0]["backend_takes"]
            print(f"mesh {group}: ranks on {[r['device'] for r in reps]}; the backend takes "
                  f"on CUDA tensors {json.dumps(takes)}")
            check(all(v == "yes" for v in takes.values()),
                  f"{group} refuses a collective the port makes on CUDA tensors: {takes}")
            leaves = torch.load(work / f"{group}_leaves.pt")
            for name, B, dtype, _, n in MESH_TRAIN:
                runs_r = [r["runs"][name] for r in reps]
                want = ref[dtype]
                got = runs_r[0]["metrics"]
                dl = max(abs(g["loss"] - w["loss"]) for g, w in zip(got, want["metrics"]))
                dg = max(abs(g["grad_norm"] - w["grad_norm"]) / w["grad_norm"]
                         for g, w in zip(got, want["metrics"]))
                db = max((leaves[name][k] - want["leaves"][k]).abs().max().item()
                         for k in want["leaves"])
                same = all(r["metrics"] == runs_r[0]["metrics"] for r in runs_r)
                row = dict(mesh=runs_r[0]["mesh"], loss=[m["loss"] for m in got],
                           max_loss_diff=dl, max_grad_norm_rel_diff=dg, max_lora_b_diff=db,
                           step_ms=[r["step_ms"] for r in runs_r],
                           peak_gb=[r["peak_gb"] for r in runs_r],
                           one_card_step_ms=want["step_ms"], one_card_peak_gb=want["peak_gb"],
                           launches=[r["launches"] for r in runs_r])
                res["train"][f"{group}_{name}"] = row
                print(f"mesh {group} {name}: " + json.dumps(row))
                check(same, f"{group} {name}: the ranks report different metrics")
                check(all(r["launches"]["flash_fwd"] and r["launches"]["flash_bwd_dq"]
                          and r["launches"]["flash_bwd_dkv"] for r in runs_r),
                      f"{group} {name}: a rank launched no flash kernel: "
                      f"{[r['launches'] for r in runs_r]}")
                if dtype == "float32":      # the CPU tests' gates
                    check(dl < 1e-5 and dg < 1e-5 and db < 1e-6,
                          f"{group} {name} against one process: loss |d| {dl:.3e}, grad "
                          f"norm rel {dg:.3e}, LoRA b |d| {db:.3e}")
                for r, rr in enumerate(runs_r):
                    res["launches_by_path"][f"mesh_{group}_{name}_rank{r}"] = rr["launches"]

        # ---- the train CLI: 2 ranks (fsdp=2) 1 step, then world 1 from their
        # checkpoint to a second ---------------------------------------------
        for group, reps in reports.items():
            run2 = work / f"train_{group}"
            tl = [r["runs"]["train_cli"] for r in reps]
            check(all(t["rc"] == 0 for t in tl),
                  f"{group} train CLI ranks returned {[t['rc'] for t in tl]}")
            rows2 = loss_rows(run2)
            check([r[2] for r in rows2].count("train") == 1,
                  f"the {group} 2-rank run's loss_log.csv rows {[r[:3] for r in rows2]}")
            one_card(f"train_cli_{group}_resumed_one_card", train, train_over(run2, 2))
            rows_r, rows_1 = loss_rows(run2), loss_rows(one_run)
            shutil.rmtree(run2 / "ckpt", ignore_errors=True)
            trains = [[float(r[3]) for r in rows if r[2] == "train"] for rows in (rows_r, rows_1)]
            d = max(abs(a - b) / abs(b) for a, b in zip(*trains))
            row = dict(mesh="dp=1 fsdp=2", two_rank_then_resumed=trains[0], one_card=trains[1],
                       max_rel_diff=d, seconds=[t["seconds"] for t in tl])
            res["train_cli"][group] = row
            print(f"mesh {group} train CLI: " + json.dumps(row))
            check(len(trains[0]) == len(trains[1]) == 2 and d < 1e-5,
                  f"{group} train CLI losses: 2 ranks then world 1 {trains[0]}, "
                  f"one card {trains[1]}")
            for r, t in enumerate(tl):
                res["launches_by_path"][f"mesh_{group}_train_cli_rank{r}"] = t["launches"]
                check(t["launches"]["flash_fwd"] and t["launches"]["flash_bwd_dq"]
                      and t["launches"]["flash_bwd_dkv"],
                      f"{group} train CLI rank {r}: {t['launches']}")

        # ---- the decode CLI ---------------------------------------------------
        for (group, reps), (tag, _, B) in itertools.product(reports.items(), MESH_DECODES):
            dl = [r["runs"][f"decode_{tag}"] for r in reps]
            out2 = work / f"dec2_{group}_{tag}"
            two, one = hyp_lines(out2), hyp_lines(work / f"dec1_{tag}")
            check(len(two) == 8, f"{group} decode {tag}: {len(two)} HYP lines")
            check(not list(out2.glob("results_*"))[1:],
                  f"{group} decode {tag}: more than one results file")
            row = dict(equal_hyps=two == one, one_card_batch=B,
                       ms_per_token_step=dl[0]["protocol_s"] * 1e3 / MESH_DECODE_TOKENS,
                       one_card_ms_per_token_step=ones[tag]["protocol_s"] * 1e3
                       / (MESH_DECODE_TOKENS * 8 // B),
                       launches=[x["launches"] for x in dl])
            res["decode"][f"{group}_{tag}"] = row
            print(f"mesh {group} decode {tag}: " + json.dumps(row))
            check(two == one, f"{group} decode {tag}: 2-rank HYP lines differ from the "
                              f"one-card decode at batch {B}")
            for r, x in enumerate(dl):
                res["launches_by_path"][f"mesh_{group}_decode_{tag}_rank{r}"] = x["launches"]
                lc = x["launches"]
                check(lc["flash_fwd"] and (tag != "preset" or (lc["qmatmul_int4"]
                                                               and lc["qmatmul_int8"])),
                      f"{group} decode {tag} rank {r} launches {lc}")
        res["backend_takes"] = {g: reps[0]["backend_takes"] for g, reps in reports.items()}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    check(not work.exists(), f"{work} not removed")
    res["seconds"] = time.perf_counter() - t_all
    print(f"mesh phase: {res['seconds']:.1f} s; launches "
          + json.dumps(res["launches_by_path"]))
    return res


# ---------------------------------------------------------------------------
# Phase 22: tensor parallelism across processes
# ---------------------------------------------------------------------------

# the tp train runs: name, global batch, compute dtype, steps, on phase
# 21's batches, seeds and weights. Every tp rank holds all rows, and over
# gloo the step's time is its all-reduces' bytes, which grow with the rows:
# a global batch of 1 (also the train CLI's) keeps the phase within the
# script's time limit
TP_TRAIN = (("f32", 1, "float32", 1), ("bf16", 1, "bfloat16", 2))
TP_CLI_BATCH = 1
# the direct decodes of the ranks: name, overrides (the f32 hypotheses are
# the decode CLI's); the one-card references add f32 and the preset in f32,
# the two modes' own yardsticks
TP_DECODES = (("bf16", ()), ("preset", PRESET_OVERRIDES))
TP_REFERENCES = (("f32", ("runtime.compute_dtype=float32",)), *TP_DECODES,
                 ("preset_f32", (*PRESET_OVERRIDES, "runtime.compute_dtype=float32")))
TP_DECODE_TOKENS = 8


def tp_decode_run(over: tuple, seed: int, mesh=None) -> dict:
    """One ``generate_tokens`` call of the flagship under ``over`` (B = 8,
    10 s audio, 25 frames, 8 tokens, no EOS; this rank's rows under a
    mesh), after a 2-token warm-up: the prefill logits, the tokens, ms per
    token step, and the shapes of layer 0's projections (the slices the
    kernels see)."""
    import torch

    from avsr_tpu_torch.cli.common import load_decode_params
    from avsr_tpu_torch.core.config import flagship
    from avsr_tpu_torch.data.loader import featurize
    from avsr_tpu_torch.infer.generate import generate_tokens
    from avsr_tpu_torch.mesh.multihost import local_rows
    from avsr_tpu_torch.mesh.sharding import take_rows

    cfg = flagship(list(over))
    dt = getattr(torch, cfg.runtime.compute_dtype)
    params = load_decode_params(cfg, seed=seed, device="cuda", mesh=mesh)
    batch = featurize(serving_host_batch(cfg, seed), "cuda", dt)
    lo, hi = 0, batch.labels.shape[0]
    if mesh is not None:
        lo, hi = local_rows(hi, (mesh.data.rank, mesh.ways))
        batch = take_rows(batch, lo, hi)
    kw = dict(max_new_tokens=TP_DECODE_TOKENS, eos_id=-1, compute_dtype=dt,
              kv_cache_dtype=cfg.decode.kv_cache_dtype, use_kernel=cfg.runtime.use_pallas)
    if mesh is not None:
        kw["sp"] = mesh.sp
    generate_tokens(params, cfg.model, batch, **{**kw, "max_new_tokens": 2})
    st: dict = {}
    torch.cuda.reset_peak_memory_stats()
    out = generate_tokens(params, cfg.model, batch, stats=st, **kw)
    torch.cuda.synchronize()
    llm = params["llm"]
    nodes = {**llm["layers"][0], "lm_head": llm.get("lm_head")}
    shapes = {f"{name}/{key}": list(node[key].shape)
              for name, node in nodes.items() if isinstance(node, dict)
              for key in ("qw4h", "qw", "w") if key in node}
    return dict(tokens=out.tokens.cpu(), logits=st["prefill_logits"].float().cpu(),
                ms_per_token=st["decode_s"] * 1e3 / max(st["decode_steps"], 1),
                peak_gb=torch.cuda.max_memory_allocated() / 1e9, rows=(lo, hi),
                shapes=shapes)


def tp_qmm_parity(seed: int) -> list[dict]:
    """The qmatmul kernels at the per-rank shapes of the preset under
    ``tp=2`` (M = 8 rows under tp alone, 4 under dp=2 tp=2): a one-block
    flagship LLM at full width, its projections int4 and its head int8 as
    the preset quantizes them, cut for each rank by ``shard_params`` (o and
    down unpacked, cut to the rank's rows of the weight and packed again;
    q, k, v, gate and up to their columns; the padded head to its vocab
    columns) and fused as the decode layout fuses them. Each wrapper call is
    held against its plain version on the same inputs at 1e-4 x max|ref|
    (the qmatmul phase's gate), and the ranks' row-parallel plain products,
    summed, against the whole leaf's."""
    import dataclasses

    import torch

    from avsr_tpu_torch.core.config import flagship
    from avsr_tpu_torch.mesh.collectives import EchoGroup
    from avsr_tpu_torch.mesh.sharding import AXES, Mesh, shard_params
    from avsr_tpu_torch.models.llama import fuse_decode_layout, init_llama
    from avsr_tpu_torch.ops import qmatmul as Q
    from avsr_tpu_torch.ops.quant import quantize_llm

    cfg = flagship(list(PRESET_OVERRIDES)).model.llm
    gen = torch.Generator(device="cuda").manual_seed(seed + 22)
    llm = quantize_llm(init_llama(gen, dataclasses.replace(cfg, n_layers=1)), 4,
                       lm_head_bits=8)
    shape = dict(zip(AXES, (1, 1, 1, 1, 1, 2, 1)))
    one = EchoGroup(1, 0)
    ranks = [fuse_decode_layout(shard_params(
        {"llm": llm}, Mesh(shape, r, world=EchoGroup(2, r), data=one, fsdp=one,
                           replica=one, tp=EchoGroup(2, r)), axes=("tp",))["llm"])
        for r in range(2)]
    whole = fuse_decode_layout(llm)

    def node(tree, name):
        return tree["lm_head"] if name == "lm_head" else tree["layers"][0][name]

    rows = []
    for M in (8, 4):
        for name in ("qkv", "o", "gateup", "down", "lm_head"):
            full = node(whole, name)
            bits = 4 if "qw4h" in full else 8
            K = full["qw4h"].shape[0] * 2 if bits == 4 else full["qw"].shape[0]
            x = torch.randn((M, K), generator=gen, device="cuda", dtype=torch.bfloat16)
            row_par = name in ("o", "down")
            refs, errs, rels = [], [], []
            for r, tree in enumerate(ranks):
                qp = node(tree, name)
                xr = x.chunk(2, dim=1)[r] if row_par else x
                y = Q.qmatmul(xr, qp)
                ref = Q.qmatmul_reference(xr, qp)
                torch.cuda.synchronize()
                errs.append((y - ref).abs().max().item())
                rels.append(errs[-1] / ref.abs().max().item())
                refs.append(ref)
                check(bool(torch.isfinite(y).all()) and rels[-1] <= 1e-4,
                      f"qmatmul tp=2 rank {r} {name} int{bits} M={M} K={xr.shape[1]} "
                      f"N={y.shape[1]}: max|d| {errs[-1]:.3e} = {rels[-1]:.3e} x max|ref|")
            row = dict(shape=f"tp2_{name}", bits=bits, M=M, K=xr.shape[1], N=y.shape[1],
                       full_K=K, full_N=full["scale"].shape[0], row_parallel=row_par,
                       max_abs_err=max(errs), max_rel_err=max(rels))
            if row_par:
                want = Q.qmatmul_reference(x, full)
                row["sum_vs_whole_rel"] = ((refs[0] + refs[1] - want).abs().max()
                                           / want.abs().max()).item()
                check(row["sum_vs_whole_rel"] <= 1e-4,
                      f"tp=2 {name}: the ranks' partial products sum to "
                      f"{row['sum_vs_whole_rel']:.3e} x max|ref| from the whole leaf's")
            rows.append(row)
    del llm, ranks, whole
    print("qmatmul at tp=2's per-rank shapes: " + "; ".join(
        f"{r['shape']} int{r['bits']} M={r['M']} K={r['K']} N={r['N']} "
        f"{r['max_rel_err']:.2e}" + (f" (sum {r['sum_vs_whole_rel']:.2e})"
                                     if r["row_parallel"] else "") for r in rows))
    return rows


def tp_phase(seed: int) -> dict:
    """Phase 22: tensor parallelism (``mesh.tp=2``) across processes at
    full width and a quarter of the depth (``MESH_DEPTH``) on the flagship:
    the train step, the train CLI and the decodes, every rank's launches
    counted (see the module docstring)."""
    import shutil

    import torch

    from avsr_tpu_torch.cli import decode, train

    t_all = time.perf_counter()
    work = ROOT / "outputs" / "chip_smoke" / time.strftime("tp_%Y%m%d_%H%M%S")
    work.mkdir(parents=True, exist_ok=True)
    flag = [*FLAGSHIP_OVERRIDES, *MESH_DEPTH]
    cli = ["--seed", str(seed), "--device", "cuda"]
    cards = torch.cuda.device_count()
    # name, ranks, sharing card 0, mesh, data-parallel ways (the global
    # batches grow with them, so each data position holds TP_TRAIN's rows)
    groups = [("gloo", 2, True, ("mesh.tp=2",), 1)]
    if cards >= 2:
        groups.append(("nccl", 2, False, ("mesh.tp=2",), 1))
    if cards >= 4:
        groups.append(("nccl_dp2", 4, False, ("mesh.tp=2", "mesh.dp=2"), 2))
    meshes = {g: " ".join(m) for g, _, _, m, _ in groups}
    print("tp phase: " + "; ".join(f"{g}: {n} ranks, {' '.join(m)}"
                                   f"{' sharing card 0' if shared else ''}"
                                   for g, n, shared, m, _ in groups)
          + ("" if cards >= 4 else f" (the host has {cards} card(s): "
             + ("no NCCL run" if cards < 2 else "no dp=2 tp=2 run") + ")"))
    res: dict = {"train": {}, "train_cli": {}, "decode_cli": {}, "decode": {},
                 "launches_by_path": {}}

    def train_over(run_dir: Path, steps: int, ways: int, *extra: str) -> list[str]:
        return [*cli, *flag, "data.synthetic=true", "data.synthetic_size=10",
                "training.grad_accum_steps=1", "training.save_every_steps=0",
                f"data.batch_size={TP_CLI_BATCH * ways}", "runtime.compute_dtype=float32",
                f"training.max_steps={steps}", f"training.checkpoint_dir={run_dir}", *extra]

    def dec_over(out: Path, *extra: str) -> list[str]:
        return [*cli, *flag, "data.synthetic=true", "data.synthetic_size=40",
                f"decode.max_new_tokens={MESH_DECODE_TOKENS}", "decode.batch_size=8",
                "runtime.compute_dtype=float32", f"decode.output_dir={out}", *extra]

    def one_card(tag: str, fn):
        torch.cuda.synchronize()
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        res["launches_by_path"][f"tp_{tag}"] = counts()
        settle()
        return out

    res["qmm_parity"] = tp_qmm_parity(seed)
    try:
        # ---- one process: the references ------------------------------------
        refs: dict = {"train": {}, "train_cli_losses": {}}
        for ways in sorted({g[4] for g in groups}):
            for _, B, d, n in TP_TRAIN:
                refs["train"][d, ways] = one_card(
                    f"train_{d}_B{B * ways}_one_card",
                    lambda B=B, d=d, n=n, ways=ways: mesh_train_run(B * ways, d, MESH_DEPTH, n))
            run1 = work / f"train_one_{ways}"
            rc = one_card(f"train_cli_B{TP_CLI_BATCH * ways}_one_card",
                          lambda run1=run1, ways=ways: train.main(train_over(run1, 2, ways)))
            check(rc == 0, f"one-card train CLI returned {rc}")
            refs["train_cli_losses"][ways] = [float(r[3]) for r in loss_rows(run1)
                                              if r[2] == "train"]
            shutil.rmtree(run1 / "ckpt", ignore_errors=True)
        rc = one_card("decode_cli_one_card", lambda: decode.main(dec_over(work / "dec1")))
        check(rc == 0, f"one-card decode CLI returned {rc}")
        refs["decode_f32_hyps"] = hyp_lines(work / "dec1")
        ones = {name: one_card(f"decode_{name}_one_card",
                               lambda over=over: tp_decode_run((*over, *MESH_DEPTH), seed))
                for name, over in TP_REFERENCES}

        # ---- the ranks ---------------------------------------------------------
        reports = {}
        for group, world, shared, mesh, ways in groups:
            runs = [dict(kind="train", name=f"train_{n}", B=B * ways, dtype=d,
                         mesh=[*mesh, *MESH_DEPTH], steps=k) for n, B, d, k in TP_TRAIN]
            runs.append(dict(kind="cli", name="train_cli", cli="train",
                             argv=train_over(work / f"train_{group}", 1, ways, *mesh)))
            runs.append(dict(kind="cli", name="decode_cli", cli="decode",
                             argv=dec_over(work / f"dec_{group}", *mesh)))
            runs += [dict(kind="decode", name=f"decode_{n}", over=[*over, *MESH_DEPTH],
                          mesh=list(mesh), seed=seed) for n, over in TP_DECODES]
            reports[group] = spawn_ranks(dict(tag=f"tp_{group}", runs=runs), work, world, shared)

        for group, reps in reports.items():
            world = len(reps)
            ways = next(g[4] for g in groups if g[0] == group)
            want_backend = "gloo" if group == "gloo" else "nccl"
            check(reps[0]["backend"] == want_backend, f"{group} ranks ran {reps[0]['backend']}")
            takes = reps[0]["backend_takes"]
            print(f"tp {group}: ranks on {[r['device'] for r in reps]}; the backend takes "
                  f"on CUDA tensors {json.dumps(takes)}")
            check(all(v == "yes" for v in takes.values()),
                  f"{group} refuses a collective the port makes on CUDA tensors: {takes}")

            # ---- the train steps against one process -------------------------
            leaves = torch.load(work / f"tp_{group}_leaves.pt")
            for n, B, dtype, steps in TP_TRAIN:
                name = f"train_{n}"
                runs_r = [r["runs"][name] for r in reps]
                want = refs["train"][dtype, ways]
                got = runs_r[0]["metrics"]
                dl = max(abs(g["loss"] - w["loss"]) for g, w in zip(got, want["metrics"]))
                dg = max(abs(g["grad_norm"] - w["grad_norm"]) / w["grad_norm"]
                         for g, w in zip(got, want["metrics"]))
                db = max((leaves[name][k] - want["leaves"][k]).abs().max().item()
                         for k in want["leaves"])
                row = dict(mesh=runs_r[0]["mesh"], global_batch=B * ways,
                           rows_per_rank=runs_r[0]["rows"],
                           loss=[m["loss"] for m in got], max_loss_diff=dl,
                           max_grad_norm_rel_diff=dg, max_lora_b_diff=db,
                           step_ms=[r["step_ms"] for r in runs_r],
                           peak_gb=[r["peak_gb"] for r in runs_r],
                           one_card_step_ms=want["step_ms"], one_card_peak_gb=want["peak_gb"],
                           launches=[r["launches"] for r in runs_r])
                res["train"][f"{group}_{n}"] = row
                print(f"tp {group} train {n}: " + json.dumps(row))
                check(all(r["metrics"] == got for r in runs_r),
                      f"tp {group} {name}: the ranks report different metrics")
                check(all(r["launches"]["flash_fwd"] and r["launches"]["flash_bwd_dq"]
                          and r["launches"]["flash_bwd_dkv"] for r in runs_r),
                      f"tp {group} {name}: a rank launched no flash kernel: "
                      f"{[r['launches'] for r in runs_r]}")
                if dtype == "float32":      # phase 21's gates, the CPU tests'
                    check(dl < 1e-5 and dg < 1e-5 and db < 1e-6,
                          f"tp {group} {name} against one process: loss |d| {dl:.3e}, grad "
                          f"norm rel {dg:.3e}, LoRA b |d| {db:.3e}")
                for r, rr in enumerate(runs_r):
                    res["launches_by_path"][f"tp_{group}_{name}_rank{r}"] = rr["launches"]

            # ---- the train CLI: 1 step on the ranks, a second at world 1 -----
            run2 = work / f"train_{group}"
            tl = [r["runs"]["train_cli"] for r in reps]
            check(all(t["rc"] == 0 for t in tl), f"tp {group} train CLI ranks returned "
                                                  f"{[t['rc'] for t in tl]}")
            rows2 = loss_rows(run2)
            check([r[2] for r in rows2].count("train") == 1,
                  f"the tp {group} run's loss_log.csv rows {[r[:3] for r in rows2]}")
            rc = one_card(f"train_cli_{group}_resumed",
                          lambda: train.main(train_over(run2, 2, ways)))
            check(rc == 0, f"tp {group}: the world-1 resume returned {rc}")
            got = [float(r[3]) for r in loss_rows(run2) if r[2] == "train"]
            shutil.rmtree(run2 / "ckpt", ignore_errors=True)
            want = refs["train_cli_losses"][ways]
            d = max(abs(a - b) / abs(b) for a, b in zip(got, want))
            row = dict(mesh=meshes[group], ranks_then_resumed=got, one_card=want, max_rel_diff=d,
                       seconds=[t["seconds"] for t in tl])
            res["train_cli"][group] = row
            print(f"tp {group} train CLI: " + json.dumps(row))
            check(len(got) == len(want) == 2 and d < 1e-5,
                  f"tp {group} train CLI losses {got}, one card {want}")
            for r, t in enumerate(tl):
                res["launches_by_path"][f"tp_{group}_train_cli_rank{r}"] = t["launches"]
                check(t["launches"]["flash_fwd"] and t["launches"]["flash_bwd_dq"]
                      and t["launches"]["flash_bwd_dkv"],
                      f"tp {group} train CLI rank {r}: {t['launches']}")

            # ---- the decode CLI in f32: one card's hypotheses -----------------
            dl_ = [r["runs"]["decode_cli"] for r in reps]
            two = hyp_lines(work / f"dec_{group}")
            row = dict(equal_hyps=two == refs["decode_f32_hyps"], lines=len(two),
                       seconds=[x["seconds"] for x in dl_], launches=[x["launches"] for x in dl_])
            res["decode_cli"][group] = row
            print(f"tp {group} decode CLI f32: " + json.dumps(row))
            check(len(two) == 8 and two == refs["decode_f32_hyps"],
                  f"tp {group} decode CLI: HYP lines differ from the one-card decode")
            for r, x in enumerate(dl_):
                res["launches_by_path"][f"tp_{group}_decode_cli_rank{r}"] = x["launches"]
                check(x["launches"]["flash_fwd"], f"tp {group} decode CLI rank {r}: "
                                                  f"{x['launches']}")

            # ---- direct decodes: logits, tokens, ms per token ------------------
            for n, _ in TP_DECODES:
                runs_r = [r["runs"][f"decode_{n}"] for r in reps]
                outs = [torch.load(work / f"tp_{group}_decode_{n}_rank{r}.pt")
                        for r in range(world)]
                one = ones[n]
                part = [slice(*x["rows"]) for x in runs_r]
                tok_one = [one["tokens"][p] for p in part]
                equal = [float((o["tokens"] == t).float().mean()) for o, t in zip(outs, tok_one)]
                dlog = [(o["logits"] - one["logits"][p]).abs() for o, p in zip(outs, part)]
                row = dict(rows=[x["rows"] for x in runs_r], equal_token_share=equal,
                           logits_vs_one_card_max=max(x.max().item() for x in dlog),
                           logits_vs_one_card_mean=max(x.mean().item() for x in dlog),
                           ms_per_token=[x["ms_per_token"] for x in runs_r],
                           one_card_ms_per_token=one["ms_per_token"],
                           peak_gb=[x["peak_gb"] for x in runs_r], one_card_peak_gb=one["peak_gb"],
                           launches=[x["launches"] for x in runs_r])
                # phase 13's bf16 gate (``logit_gates``): no further from the
                # mode's f32 logits than 2x one card is, in mean and in max
                ref32 = ones["f32" if n == "bf16" else "preset_f32"]["logits"]
                own = (one["logits"] - ref32).abs()
                mine = [(o["logits"] - ref32[p]).abs() for o, p in zip(outs, part)]
                row.update(own_vs_f32_mean=own.mean().item(), own_vs_f32_max=own.max().item(),
                           tp_vs_f32_mean=max(x.mean().item() for x in mine),
                           tp_vs_f32_max=max(x.max().item() for x in mine))
                check(row["tp_vs_f32_mean"] <= 2.0 * row["own_vs_f32_mean"]
                      and row["tp_vs_f32_max"] <= 2.0 * row["own_vs_f32_max"],
                      f"tp {group} decode {n}: logits |d| to f32 (mean "
                      f"{row['tp_vs_f32_mean']:.4e}, max {row['tp_vs_f32_max']:.4e}) "
                      f"beyond 2x one card's ({row['own_vs_f32_mean']:.4e}, "
                      f"{row['own_vs_f32_max']:.4e})")
                if n == "preset":
                    sh = runs_r[0]["shapes"]
                    row["int4_slices"] = {k: dict(shape=v, K=2 * v[0], N=v[1])
                                          for k, v in sh.items() if k.endswith("qw4h")}
                    row["int8_head"] = dict(shape=sh["lm_head/qw"], N=sh["lm_head/qw"][1])
                    print(f"tp {group} preset: the int4 kernel's K x N per slice "
                          + json.dumps({k: f"{v['K']} x {v['N']}"
                                        for k, v in row["int4_slices"].items()})
                          + f"; the int8 head's vocab slice {row['int8_head']['shape']}")
                res["decode"][f"{group}_{n}"] = row
                print(f"tp {group} decode {n}: " + json.dumps(row))
                for r, x in enumerate(runs_r):
                    res["launches_by_path"][f"tp_{group}_decode_{n}_rank{r}"] = x["launches"]
                    lc = x["launches"]
                    check(lc["flash_fwd"] and (n != "preset" or (lc["qmatmul_int4"]
                                                                 and lc["qmatmul_int8"])),
                          f"tp {group} decode {n} rank {r} launches {lc}")
        res["backend_takes"] = {g: reps[0]["backend_takes"] for g, reps in reports.items()}
        # phase 22's one-process runs at the quarter depth, which phase 23's
        # steps, decodes and CLIs and phase 24's decode CLI reuse (not JSON)
        res["refs"] = dict(refs, decodes=ones)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    check(not work.exists(), f"{work} not removed")
    res["seconds"] = time.perf_counter() - t_all
    print(f"tp phase: {res['seconds']:.1f} s; launches " + json.dumps(res["launches_by_path"]))
    return res


# ---------------------------------------------------------------------------
# Phase 23: sequence parallelism across processes
# ---------------------------------------------------------------------------

# the ring at the flagship's 30 s bucket, global batch 1: name, heads, kv
# heads, rows (Whisper's 1500 padded to 1504; the LLM's 33 prompt + 1500
# features + 48 labels packed to 1584), valid rows, causal
SP_RING_SHAPES = (("whisper", 16, 16, 1504, 1500, False), ("llm", 32, 8, 1584, 1581, True))


def sp_ring_rows(mesh, seed: int) -> list[dict]:
    """This rank's ring attention (bf16, through the flash kernels) at
    ``SP_RING_SHAPES``: every rank makes the same whole q, k, v and dO from
    ``seed``, runs the ring on its chunk (q_lens = kv_lens = the valid rows)
    and holds its chunk of O and of dq, dk, dv against ``mha_reference`` of
    the whole sequence in f32 (the flash gates: 2e-2 forward, 2e-2 x max|ref|
    backward); the ring's launches against the blocks it must launch (all
    of them, and under ``causal`` rank i's i + 1); the forward's ms with the
    kernels and with the plain blocks, from CUDA events around 5 calls
    (every rank times the same calls: the shifts are collectives)."""
    import torch

    from avsr_tpu_torch.ops import attention as A
    from avsr_tpu_torch.ops import ring_attention as R

    sp = mesh.sp
    n, r = sp.size, sp.rank
    rows = []
    for name, H, Hkv, T, valid, causal in SP_RING_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(seed + 23)

        def rand(h):
            return torch.randn((1, h, T, 64), generator=g, device="cuda", dtype=torch.bfloat16)

        q, k, v, do = rand(H), rand(Hkv), rand(Hkv), rand(H)
        lens = torch.tensor([valid], device="cuda")
        c = T // n

        def mine(t):
            return t[:, :, r * c:(r + 1) * c].contiguous()

        xs = [mine(t).requires_grad_(True) for t in (q, k, v)]
        before = dict(R.launches)
        o = R.ring_attention(*xs, group=sp, causal=causal, kv_lens=lens, q_lens=lens)
        o.backward(mine(do))
        torch.cuda.synchronize()
        launched = {key: R.launches[key] - before[key] for key in before}
        blocks = r + 1 if causal else n
        check(launched == dict(flash_fwd=blocks, flash_bwd_dq=blocks, flash_bwd_dkv=blocks),
              f"ring {name} rank {r}: launched {launched}, {blocks} blocks expected")
        ref_in = [t.float().requires_grad_(True) for t in (q, k, v)]
        ref = A.mha_reference(*ref_in, causal=causal, q_lens=lens, kv_lens=lens)
        ref.backward(do.float())
        err = (o.float() - mine(ref.detach())).abs().max().item()
        rel = {}
        for key, x, t in zip(("dq", "dk", "dv"), xs, ref_in):
            want = mine(t.grad)
            rel[key] = ((x.grad.float() - want).abs().max() / want.abs().max()).item()
        check(all(torch.isfinite(t).all() for t in (o, *[x.grad for x in xs])),
              f"ring {name} rank {r}: non-finite output or gradient")
        check(err <= 2e-2 and max(rel.values()) <= 2e-2,
              f"ring {name} rank {r} against the whole sequence: O max|d| {err:.3e}, "
              f"dq/dk/dv max|d| / max|ref| {rel}")
        del ref, ref_in, xs, o
        ms = {}
        with torch.no_grad():
            chunks = [mine(t) for t in (q, k, v)]
            for tag, uk in (("ms", "auto"), ("plain_ms", "never")):
                R.ring_attention(*chunks, group=sp, causal=causal, kv_lens=lens,
                                 q_lens=lens, use_kernel=uk)
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                torch.cuda.synchronize()
                start.record()
                for _ in range(5):
                    R.ring_attention(*chunks, group=sp, causal=causal, kv_lens=lens,
                                     q_lens=lens, use_kernel=uk)
                end.record()
                torch.cuda.synchronize()
                ms[tag] = start.elapsed_time(end) / 5
        rows.append(dict(shape=name, q=[1, H, c, 64], kv=[1, Hkv, c, 64], rows=T,
                         valid=valid, valid_in_chunk=max(0, min(c, valid - r * c)),
                         causal=causal, rank=r, blocks=blocks, launched=launched,
                         max_abs_err=err, max_rel_err_bwd=rel, **ms))
    return rows


def sp_train_launches(cfg, rank: int, n: int) -> dict[str, int]:
    """The flash launches of one train step (one micro-batch) of sp rank
    ``rank`` of ``n``: the frozen Whisper's blocks each ring over every
    chunk (forward only), and the LLM's blocks each ring over the rank's
    causal blocks, again in remat's recomputation, with a backward pair a
    block."""
    m = cfg.model
    llm = m.llm.n_layers * (rank + 1)
    return dict(flash_fwd=m.whisper.n_layers * n + llm * (2 if cfg.mesh.remat else 1),
                flash_bwd_dq=llm, flash_bwd_dkv=llm, qmatmul_int8=0, qmatmul_int4=0)


def sp_phase(seed: int, refs: dict | None = None) -> dict:
    """Phase 23: sequence parallelism (``mesh.sp=2``) across processes at
    full width on the flagship, global batch 1 at the largest buckets: the
    ring against the whole sequence at the full depth's 30 s shapes; the
    train step with exact launches per rank, the decodes and the train and
    decode CLIs at phase 22's quarter depth, against phase 22's one-card
    runs of them (``refs``; made here without them). See the module
    docstring."""
    import shutil

    import torch

    from avsr_tpu_torch.cli import decode, train

    t_all = time.perf_counter()
    work = ROOT / "outputs" / "chip_smoke" / time.strftime("sp_%Y%m%d_%H%M%S")
    work.mkdir(parents=True, exist_ok=True)
    flag = [*FLAGSHIP_OVERRIDES, *MESH_DEPTH]          # phase 22's
    cli = ["--seed", str(seed), "--device", "cuda"]
    cards = torch.cuda.device_count()
    # name, ranks, sharing card 0, mesh, data-parallel ways
    groups = [("gloo", 2, True, ("mesh.sp=2",), 1)]
    if cards >= 2:
        groups.append(("nccl", 2, False, ("mesh.sp=2",), 1))
    if cards >= 4:
        groups.append(("nccl_dp2", 4, False, ("mesh.sp=2", "mesh.dp=2"), 2))
    print("sp phase: " + "; ".join(f"{g}: {n} ranks, {' '.join(m)}"
                                   f"{' sharing card 0' if shared else ''}"
                                   for g, n, shared, m, _ in groups)
          + ("" if cards >= 4 else f" (the host has {cards} card(s): "
             + ("no NCCL run" if cards < 2 else "no dp=2 sp=2 run") + ")"))
    res: dict = {"ring": {}, "train": {}, "train_cli": {}, "decode_cli": {}, "decode": {},
                 "launches_by_path": {}}

    def train_over(run_dir: Path, steps: int, ways: int, *extra: str) -> list[str]:
        return [*cli, *flag, "data.synthetic=true", "data.synthetic_size=10",
                "training.grad_accum_steps=1", "training.save_every_steps=0",
                f"data.batch_size={TP_CLI_BATCH * ways}", "runtime.compute_dtype=float32",
                f"training.max_steps={steps}", f"training.checkpoint_dir={run_dir}", *extra]

    def dec_over(out: Path, *extra: str) -> list[str]:
        return [*cli, *flag, "data.synthetic=true", "data.synthetic_size=40",
                f"decode.max_new_tokens={MESH_DECODE_TOKENS}", "decode.batch_size=8",
                "runtime.compute_dtype=float32", f"decode.output_dir={out}", *extra]

    def one_card(tag: str, fn):
        torch.cuda.synchronize()
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        res["launches_by_path"][f"sp_{tag}"] = counts()
        settle()
        return out

    try:
        # ---- one process: the references (phase 22's, or made here) --------
        if refs is None:
            refs = {"train": {}, "train_cli_losses": {}}
            for ways in sorted({g[4] for g in groups}):
                for _, B, d, n in TP_TRAIN:
                    refs["train"][d, ways] = one_card(
                        f"train_{d}_B{B * ways}_one_card",
                        lambda B=B, d=d, n=n, ways=ways: mesh_train_run(B * ways, d, MESH_DEPTH,
                                                                        n))
                run1 = work / f"train_one_{ways}"
                rc = one_card(f"train_cli_B{TP_CLI_BATCH * ways}_one_card",
                              lambda run1=run1, ways=ways: train.main(train_over(run1, 2, ways)))
                check(rc == 0, f"one-card train CLI returned {rc}")
                refs["train_cli_losses"][ways] = [float(r[3]) for r in loss_rows(run1)
                                                  if r[2] == "train"]
                shutil.rmtree(run1 / "ckpt", ignore_errors=True)
            rc = one_card("decode_cli_one_card", lambda: decode.main(dec_over(work / "dec1")))
            check(rc == 0, f"one-card decode CLI returned {rc}")
            refs["decode_f32_hyps"] = hyp_lines(work / "dec1")
            refs["decodes"] = {name: one_card(f"decode_{name}_one_card",
                                              lambda over=over: tp_decode_run(
                                                  (*over, *MESH_DEPTH), seed))
                               for name, over in TP_REFERENCES}
        ones = refs["decodes"]

        # ---- the ranks ---------------------------------------------------------
        reports = {}
        for group, world, shared, mesh, ways in groups:
            runs = [dict(kind="ring", name="ring", mesh=list(mesh), seed=seed)]
            runs += [dict(kind="train", name=f"train_{n}", B=B * ways, dtype=d,
                          mesh=[*mesh, *MESH_DEPTH], steps=k) for n, B, d, k in TP_TRAIN]
            runs.append(dict(kind="cli", name="train_cli", cli="train",
                             argv=train_over(work / f"train_{group}", 1, ways, *mesh)))
            runs.append(dict(kind="cli", name="decode_cli", cli="decode",
                             argv=dec_over(work / f"dec_{group}", *mesh)))
            runs += [dict(kind="decode", name=f"decode_{n}", over=[*over, *MESH_DEPTH],
                          mesh=list(mesh), seed=seed) for n, over in TP_DECODES]
            reports[group] = spawn_ranks(dict(tag=f"sp_{group}", runs=runs), work, world, shared)

        for group, reps in reports.items():
            world = len(reps)
            ways = next(g[4] for g in groups if g[0] == group)
            check(reps[0]["backend"] == ("gloo" if group == "gloo" else "nccl"),
                  f"{group} ranks ran {reps[0]['backend']}")
            takes = reps[0]["backend_takes"]
            print(f"sp {group}: ranks on {[r['device'] for r in reps]}; the backend takes "
                  f"on CUDA tensors {json.dumps(takes)}")
            check(all(v == "yes" for v in takes.values()),
                  f"{group} refuses a collective the port makes on CUDA tensors: {takes}")
            res["ring"][group] = [r["runs"]["ring"]["rows"] for r in reps]
            print(f"sp {group} ring: " + json.dumps(res["ring"][group]))
            for r, rep_ in enumerate(reps):
                res["launches_by_path"][f"sp_{group}_ring_rank{r}"] = rep_["runs"]["ring"][
                    "launches"]

            # ---- the train steps: one process's, exact launches per rank --------
            leaves = torch.load(work / f"sp_{group}_leaves.pt")
            for n, B, dtype, steps in TP_TRAIN:
                name = f"train_{n}"
                runs_r = [r["runs"][name] for r in reps]
                want = refs["train"][dtype, ways]
                got = runs_r[0]["metrics"]
                dl = max(abs(g["loss"] - w["loss"]) for g, w in zip(got, want["metrics"]))
                dg = max(abs(g["grad_norm"] - w["grad_norm"]) / w["grad_norm"]
                         for g, w in zip(got, want["metrics"]))
                db = max((leaves[name][k] - want["leaves"][k]).abs().max().item()
                         for k in want["leaves"])
                row = dict(mesh=runs_r[0]["mesh"], global_batch=B * ways,
                           loss=[m["loss"] for m in got], max_loss_diff=dl,
                           max_grad_norm_rel_diff=dg, max_lora_b_diff=db,
                           step_ms=[r["step_ms"] for r in runs_r],
                           peak_gb=[r["peak_gb"] for r in runs_r],
                           one_card_step_ms=want["step_ms"], one_card_peak_gb=want["peak_gb"],
                           launches=[r["launches"] for r in runs_r])
                res["train"][f"{group}_{n}"] = row
                print(f"sp {group} train {n}: " + json.dumps(row))
                check(all(r["metrics"] == got for r in runs_r),
                      f"sp {group} {name}: the ranks report different metrics")
                cfg = mesh_cfg(dtype, MESH_DEPTH)
                for r, rr in enumerate(runs_r):
                    sp_rank = rr["sp_rank"]
                    exact = {k: v * steps for k, v in sp_train_launches(cfg, sp_rank, 2).items()}
                    check(rr["launches"] == exact,
                          f"sp {group} {name} rank {r}: launches {rr['launches']}, "
                          f"expected {exact}")
                    res["launches_by_path"][f"sp_{group}_{name}_rank{r}"] = rr["launches"]
                if dtype == "float32":      # phase 21's gates
                    check(dl < 1e-5 and dg < 1e-5 and db < 1e-6,
                          f"sp {group} {name} against one process: loss |d| {dl:.3e}, grad "
                          f"norm rel {dg:.3e}, LoRA b |d| {db:.3e}")

            # ---- the train CLI: 1 step on the ranks, a second at world 1 -----
            run2 = work / f"train_{group}"
            tl = [r["runs"]["train_cli"] for r in reps]
            check(all(t["rc"] == 0 for t in tl), f"sp {group} train CLI ranks returned "
                                                  f"{[t['rc'] for t in tl]}")
            rows2 = loss_rows(run2)
            check([r[2] for r in rows2].count("train") == 1,
                  f"the sp {group} run's loss_log.csv rows {[r[:3] for r in rows2]}")
            rc = one_card(f"train_cli_{group}_resumed",
                          lambda: train.main(train_over(run2, 2, ways)))
            check(rc == 0, f"sp {group}: the world-1 resume returned {rc}")
            got = [float(r[3]) for r in loss_rows(run2) if r[2] == "train"]
            shutil.rmtree(run2 / "ckpt", ignore_errors=True)
            want = refs["train_cli_losses"][ways]
            d = max(abs(a - b) / abs(b) for a, b in zip(got, want))
            row = dict(ranks_then_resumed=got, one_card=want, max_rel_diff=d,
                       seconds=[t["seconds"] for t in tl])
            res["train_cli"][group] = row
            print(f"sp {group} train CLI: " + json.dumps(row))
            check(len(got) == len(want) == 2 and d < 1e-5,
                  f"sp {group} train CLI losses {got}, one card {want}")
            for r, t in enumerate(tl):
                res["launches_by_path"][f"sp_{group}_train_cli_rank{r}"] = t["launches"]
                check(t["launches"]["flash_fwd"] and t["launches"]["flash_bwd_dq"]
                      and t["launches"]["flash_bwd_dkv"],
                      f"sp {group} train CLI rank {r}: {t['launches']}")

            # ---- the decode CLI in f32: one card's hypotheses -----------------
            dl_ = [r["runs"]["decode_cli"] for r in reps]
            two = hyp_lines(work / f"dec_{group}")
            row = dict(equal_hyps=two == refs["decode_f32_hyps"], lines=len(two),
                       seconds=[x["seconds"] for x in dl_], launches=[x["launches"] for x in dl_])
            res["decode_cli"][group] = row
            print(f"sp {group} decode CLI f32: " + json.dumps(row))
            check(len(two) == 8 and two == refs["decode_f32_hyps"],
                  f"sp {group} decode CLI: HYP lines differ from the one-card decode")
            for r, x in enumerate(dl_):
                res["launches_by_path"][f"sp_{group}_decode_cli_rank{r}"] = x["launches"]
                check(x["launches"]["flash_fwd"], f"sp {group} decode CLI rank {r}: "
                                                  f"{x['launches']}")

            # ---- direct decodes: logits, tokens, ms per token ------------------
            for n, _ in TP_DECODES:
                runs_r = [r["runs"][f"decode_{n}"] for r in reps]
                outs = [torch.load(work / f"sp_{group}_decode_{n}_rank{r}.pt")
                        for r in range(world)]
                one = ones[n]
                part = [slice(*x["rows"]) for x in runs_r]
                equal = [float((o["tokens"] == one["tokens"][p]).float().mean())
                         for o, p in zip(outs, part)]
                ref32 = ones["f32" if n == "bf16" else "preset_f32"]["logits"]
                own = (one["logits"] - ref32).abs()
                mine = [(o["logits"] - ref32[p]).abs() for o, p in zip(outs, part)]
                row = dict(rows=[x["rows"] for x in runs_r], equal_token_share=equal,
                           ms_per_token=[x["ms_per_token"] for x in runs_r],
                           one_card_ms_per_token=one["ms_per_token"],
                           peak_gb=[x["peak_gb"] for x in runs_r], one_card_peak_gb=one["peak_gb"],
                           own_vs_f32_mean=own.mean().item(), own_vs_f32_max=own.max().item(),
                           sp_vs_f32_mean=max(x.mean().item() for x in mine),
                           sp_vs_f32_max=max(x.max().item() for x in mine),
                           prefill_rings=[x["rings"] for x in runs_r],
                           prefill_fallbacks=runs_r[0]["fallbacks"],
                           launches=[x["launches"] for x in runs_r])
                # phase 13's gate: no further from the mode's f32 logits than
                # 2x one card is, in mean and in max
                check(row["sp_vs_f32_mean"] <= 2.0 * row["own_vs_f32_mean"]
                      and row["sp_vs_f32_max"] <= 2.0 * row["own_vs_f32_max"],
                      f"sp {group} decode {n}: logits |d| to f32 (mean "
                      f"{row['sp_vs_f32_mean']:.4e}, max {row['sp_vs_f32_max']:.4e}) "
                      f"beyond 2x one card's ({row['own_vs_f32_mean']:.4e}, "
                      f"{row['own_vs_f32_max']:.4e})")
                res["decode"][f"{group}_{n}"] = row
                print(f"sp {group} decode {n}: " + json.dumps(row))
                for r, x in enumerate(runs_r):
                    res["launches_by_path"][f"sp_{group}_decode_{n}_rank{r}"] = x["launches"]
                    lc = x["launches"]
                    check(lc["flash_fwd"] and (n != "preset" or (lc["qmatmul_int4"]
                                                                 and lc["qmatmul_int8"])),
                          f"sp {group} decode {n} rank {r} launches {lc}")
        res["backend_takes"] = {g: reps[0]["backend_takes"] for g, reps in reports.items()}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    check(not work.exists(), f"{work} not removed")
    res["seconds"] = time.perf_counter() - t_all
    print(f"sp phase: {res['seconds']:.1f} s; launches " + json.dumps(res["launches_by_path"]))
    return res


# ---------------------------------------------------------------------------
# Phase 24: pipeline parallelism across processes
# ---------------------------------------------------------------------------

# the pp meshes' overrides: JAX refuses LoRA dropout under pp
PP_OVER = ("mesh.pp=2", "model.lora.dropout=0")
# name, global batch per data position (2 microbatches of 1 row a stage),
# dtype, steps
PP_TRAIN = (("f32", 2, "float32", 1), ("bf16", 2, "bfloat16", 2))
PP_CLI_BATCH = 2


def pp_stage_shape(cfg, rows: int, ways: int) -> str:
    """The q of a stage's causal LLM blocks in one train step (``rows`` rows
    on each of ``ways`` data positions): a microbatch's rows, the LLM's
    heads, the packed rows of the flagship's 30 s bucket (``SP_RING_SHAPES``)
    and the head width, over the LLM's kv heads."""
    from avsr_tpu_torch.ops.pipeline import split_count

    llm = cfg.model.llm
    T = next(t for name, _, _, t, _, _ in SP_RING_SHAPES if name == "llm")
    mb = rows // split_count(rows, rows * ways, cfg.mesh.pp)
    return (f"{[mb, llm.n_heads, T, llm.d_model // llm.n_heads]} causal GQA over "
            f"{llm.n_kv_heads} kv heads, a microbatch")


def pp_train_launches(cfg, rows: int, ways: int) -> dict[str, int]:
    """The flash launches of one train step (one micro-batch, ``rows`` rows
    on each of ``ways`` data positions) on any stage of ``cfg.mesh.pp``: the
    frozen Whisper's blocks once (every stage runs the encoders), the
    stage's ``n_layers / pp`` causal LLM blocks once per microbatch it
    holds, again in remat's recomputation, with a backward pair each."""
    from avsr_tpu_torch.ops.pipeline import split_count

    m, S = cfg.model, cfg.mesh.pp
    llm = m.llm.n_layers // S * split_count(rows, rows * ways, S)
    return dict(flash_fwd=m.whisper.n_layers + llm * (2 if cfg.mesh.remat else 1),
                flash_bwd_dq=llm, flash_bwd_dkv=llm, qmatmul_int8=0, qmatmul_int4=0)


def pp_phase(seed: int, refs: dict | None = None) -> dict:
    """Phase 24: pipeline parallelism (``mesh.pp=2``) across processes on
    the flagship: the train steps at full width and depth (8 LLM blocks a
    stage) with exact launches per rank against one process; the train and
    decode CLIs at phase 22's quarter depth, the decode CLI's f32
    hypotheses against phase 22's one-card decode (``refs``; made here
    without them). See the module docstring."""
    import shutil

    import torch

    from avsr_tpu_torch.cli import decode, train

    t_all = time.perf_counter()
    work = ROOT / "outputs" / "chip_smoke" / time.strftime("pp_%Y%m%d_%H%M%S")
    work.mkdir(parents=True, exist_ok=True)
    flag = [*FLAGSHIP_OVERRIDES, *MESH_DEPTH]          # the CLIs' (phase 22's)
    cli = ["--seed", str(seed), "--device", "cuda"]
    cards = torch.cuda.device_count()
    # name, ranks, sharing card 0, mesh, data-parallel ways
    groups = [("gloo", 2, True, PP_OVER, 1)]
    if cards >= 2:
        groups.append(("nccl", 2, False, PP_OVER, 1))
    if cards >= 4:
        groups.append(("nccl_dp2", 4, False, (*PP_OVER, "mesh.dp=2"), 2))
    print("pp phase: " + "; ".join(f"{g}: {n} ranks, {' '.join(m)}"
                                   f"{' sharing card 0' if shared else ''}"
                                   for g, n, shared, m, _ in groups)
          + ("" if cards >= 4 else f" (the host has {cards} card(s): "
             + ("no NCCL run" if cards < 2 else "no dp=2 pp=2 run") + ")"))
    res: dict = {"train": {}, "train_cli": {}, "decode_cli": {}, "launches_by_path": {}}

    def train_over(run_dir: Path, steps: int, ways: int, *extra: str) -> list[str]:
        return [*cli, *flag, "data.synthetic=true", "data.synthetic_size=10",
                "training.grad_accum_steps=1", "training.save_every_steps=0",
                f"data.batch_size={PP_CLI_BATCH * ways}", "runtime.compute_dtype=float32",
                "model.lora.dropout=0", f"training.max_steps={steps}",
                f"training.checkpoint_dir={run_dir}", *extra]

    def dec_over(out: Path, *extra: str) -> list[str]:
        return [*cli, *flag, "data.synthetic=true", "data.synthetic_size=40",
                f"decode.max_new_tokens={MESH_DECODE_TOKENS}", "decode.batch_size=8",
                "runtime.compute_dtype=float32", f"decode.output_dir={out}", *extra]

    def one_card(tag: str, fn):
        torch.cuda.synchronize()
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        res["launches_by_path"][f"pp_{tag}"] = counts()
        settle()
        return out

    try:
        # ---- one process: the references ------------------------------------
        ref_train, ref_cli = {}, {}
        for ways in sorted({g[4] for g in groups}):
            for _, B, d, n in PP_TRAIN:
                ref_train[d, ways] = one_card(
                    f"train_{d}_B{B * ways}_one_card",
                    lambda B=B, d=d, n=n, ways=ways: mesh_train_run(
                        B * ways, d, ("model.lora.dropout=0",), n))
            run1 = work / f"train_one_{ways}"
            rc = one_card(f"train_cli_B{PP_CLI_BATCH * ways}_one_card",
                          lambda run1=run1, ways=ways: train.main(train_over(run1, 2, ways)))
            check(rc == 0, f"one-card train CLI returned {rc}")
            ref_cli[ways] = [float(r[3]) for r in loss_rows(run1) if r[2] == "train"]
            shutil.rmtree(run1 / "ckpt", ignore_errors=True)
        if refs is None:
            rc = one_card("decode_cli_one_card", lambda: decode.main(dec_over(work / "dec1")))
            check(rc == 0, f"one-card decode CLI returned {rc}")
            refs = {"decode_f32_hyps": hyp_lines(work / "dec1")}

        # ---- the ranks ---------------------------------------------------------
        reports = {}
        for group, world, shared, mesh, ways in groups:
            runs = [dict(kind="train", name=f"train_{n}", B=B * ways, dtype=d, mesh=list(mesh),
                         steps=k) for n, B, d, k in PP_TRAIN]
            runs.append(dict(kind="cli", name="train_cli", cli="train",
                             argv=train_over(work / f"train_{group}", 1, ways, *mesh)))
            runs.append(dict(kind="cli", name="decode_cli", cli="decode",
                             argv=dec_over(work / f"dec_{group}", *mesh)))
            runs.append(dict(kind="cli", name="decode_cli_preset", cli="decode",
                             argv=dec_over(work / f"dec_preset_{group}", *mesh,
                                           *PRESET_OVERRIDES)))
            reports[group] = spawn_ranks(dict(tag=f"pp_{group}", runs=runs), work, world, shared)

        for group, reps in reports.items():
            world = len(reps)
            ways = next(g[4] for g in groups if g[0] == group)
            check(reps[0]["backend"] == ("gloo" if group == "gloo" else "nccl"),
                  f"{group} ranks ran {reps[0]['backend']}")
            takes = reps[0]["backend_takes"]
            print(f"pp {group}: ranks on {[r['device'] for r in reps]}; the backend takes "
                  f"on CUDA tensors {json.dumps(takes)}")
            check(all(v == "yes" for v in takes.values()),
                  f"{group} refuses a collective the port makes on CUDA tensors: {takes}")

            # ---- the train steps: one process's, exact launches per rank --------
            leaves = torch.load(work / f"pp_{group}_leaves.pt")
            for n, B, dtype, steps in PP_TRAIN:
                name = f"train_{n}"
                runs_r = [r["runs"][name] for r in reps]
                want = ref_train[dtype, ways]
                got = runs_r[0]["metrics"]
                dl = max(abs(g["loss"] - w["loss"]) for g, w in zip(got, want["metrics"]))
                dg = max(abs(g["grad_norm"] - w["grad_norm"]) / w["grad_norm"]
                         for g, w in zip(got, want["metrics"]))
                db = {k: (leaves[name][k] - want["leaves"][k]).abs().max().item()
                      for k in want["leaves"]}
                row = dict(mesh=runs_r[0]["mesh"], global_batch=B * ways,
                           stages=[r["pp_rank"] for r in runs_r],
                           loss=[m["loss"] for m in got], max_loss_diff=dl,
                           max_grad_norm_rel_diff=dg, lora_b_diff=db,
                           step_ms=[r["step_ms"] for r in runs_r],
                           peak_gb=[r["peak_gb"] for r in runs_r],
                           one_card_step_ms=want["step_ms"], one_card_peak_gb=want["peak_gb"],
                           launches=[r["launches"] for r in runs_r])
                res["train"][f"{group}_{n}"] = row
                print(f"pp {group} train {n}: " + json.dumps(row))
                check(all(r["metrics"] == got for r in runs_r),
                      f"pp {group} {name}: the ranks report different metrics")
                cfg = mesh_cfg(dtype, mesh)
                exact = {k: v * steps for k, v in pp_train_launches(cfg, B, ways).items()}
                if group == "gloo":
                    res["stage_shape"] = pp_stage_shape(cfg, B, ways)
                for r, rr in enumerate(runs_r):
                    check(rr["launches"] == exact,
                          f"pp {group} {name} rank {r}: launches {rr['launches']}, "
                          f"expected {exact}")
                    res["launches_by_path"][f"pp_{group}_{name}_rank{r}"] = rr["launches"]
                if dtype == "float32":      # phase 21's gates
                    check(dl < 1e-5 and dg < 1e-5 and max(db.values()) < 1e-6,
                          f"pp {group} {name} against one process: loss |d| {dl:.3e}, grad "
                          f"norm rel {dg:.3e}, LoRA b |d| {db}")

            # ---- the train CLI: 1 step on the ranks, a second at world 1 -----
            run2 = work / f"train_{group}"
            tl = [r["runs"]["train_cli"] for r in reps]
            check(all(t["rc"] == 0 for t in tl), f"pp {group} train CLI ranks returned "
                                                  f"{[t['rc'] for t in tl]}")
            rows2 = loss_rows(run2)
            check([r[2] for r in rows2].count("train") == 1,
                  f"the pp {group} run's loss_log.csv rows {[r[:3] for r in rows2]}")
            rc = one_card(f"train_cli_{group}_resumed",
                          lambda: train.main(train_over(run2, 2, ways)))
            check(rc == 0, f"pp {group}: the world-1 resume returned {rc}")
            got = [float(r[3]) for r in loss_rows(run2) if r[2] == "train"]
            shutil.rmtree(run2 / "ckpt", ignore_errors=True)
            want = ref_cli[ways]
            d = max(abs(a - b) / abs(b) for a, b in zip(got, want))
            row = dict(ranks_then_resumed=got, one_card=want, max_rel_diff=d,
                       seconds=[t["seconds"] for t in tl])
            res["train_cli"][group] = row
            print(f"pp {group} train CLI: " + json.dumps(row))
            check(len(got) == len(want) == 2 and d < 1e-5,
                  f"pp {group} train CLI losses {got}, one card {want}")
            for r, t in enumerate(tl):
                res["launches_by_path"][f"pp_{group}_train_cli_rank{r}"] = t["launches"]
                check(t["launches"]["flash_fwd"] and t["launches"]["flash_bwd_dq"]
                      and t["launches"]["flash_bwd_dkv"],
                      f"pp {group} train CLI rank {r}: {t['launches']}")

            # ---- the decode CLI: f32 hypotheses, the preset's kernels --------
            for tag in ("decode_cli", "decode_cli_preset"):
                dl_ = [r["runs"][tag] for r in reps]
                check(all(x["rc"] == 0 for x in dl_), f"pp {group} {tag} ranks returned "
                                                      f"{[x['rc'] for x in dl_]}")
                row = dict(seconds=[x["seconds"] for x in dl_],
                           launches=[x["launches"] for x in dl_])
                for r, x in enumerate(dl_):
                    res["launches_by_path"][f"pp_{group}_{tag}_rank{r}"] = x["launches"]
                    lc = x["launches"]
                    check(lc["flash_fwd"] and (tag == "decode_cli" or (
                        lc["qmatmul_int4"] and lc["qmatmul_int8"])),
                        f"pp {group} {tag} rank {r}: {lc}")
                if tag == "decode_cli":
                    two = hyp_lines(work / f"dec_{group}")
                    row.update(equal_hyps=two == refs["decode_f32_hyps"], lines=len(two))
                    check(len(two) == 8 and two == refs["decode_f32_hyps"],
                          f"pp {group} decode CLI: HYP lines differ from the one-card decode")
                res["decode_cli"][f"{group}_{tag}"] = row
                print(f"pp {group} {tag}: " + json.dumps(row))
        res["backend_takes"] = {g: reps[0]["backend_takes"] for g, reps in reports.items()}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    check(not work.exists(), f"{work} not removed")
    res["seconds"] = time.perf_counter() - t_all
    print(f"pp phase: {res['seconds']:.1f} s; launches " + json.dumps(res["launches_by_path"]))
    return res


# ---------------------------------------------------------------------------
# Phase 25: mixture of experts across processes and expert parallelism
# ---------------------------------------------------------------------------

# flagship_moe() with both capacity factors at 0.25, so that the bounded
# training routing drops assignments (phase 18's gates)
EP_OVER = (*MOE_OVERRIDES, *MOE_SQUEEZE)
EP_BUCKET = (1000, 25)          # phase 18's: 10 s of audio, 25 frames
# the train runs at full depth: name, rows per data rank, dtype, steps
EP_TRAIN = (("f32", 1, "float32", 1), ("bf16", 4, "bfloat16", 2))
# the sp run: phase 21's quarter depth at the 20 s bucket (the ring's
# chunks, 500 Whisper and 544 LLM rows, take the flash kernels), batch 1
EP_SP = ("mesh.sp=2", *MESH_DEPTH)
EP_SP_BUCKET = (2000, 50)
EP_CLI_BATCH = 1                # the train CLI's rows per data rank
# the CLIs run audio-only with 2 LLM blocks, one of them sparse (one moe
# connector and one MoE block): each train CLI run writes an f32
# checkpoint of the connector's experts and their Adam moments, 11.8 GB
# with both connectors and the quarter depth (~17 s a write, three writes),
# which the script's time limit cannot hold
EP_CLI = ("model.modality=audio", "model.llm.n_layers=2")


def ep_phase(seed: int) -> dict:
    """Phase 25: mixture of experts across processes with ``mesh.ep=2`` on
    ``flagship_moe()`` (both capacity factors at 0.25): the train steps at
    full width and depth against one process, with exact launches per rank,
    the experts split over ep and assignments dropped; an sp=2 step at the
    quarter depth; the train and decode CLIs at the quarter depth. See the
    module docstring."""
    import shutil

    import torch

    from avsr_tpu_torch.cli import decode, train

    t_all = time.perf_counter()
    work = ROOT / "outputs" / "chip_smoke" / time.strftime("ep_%Y%m%d_%H%M%S")
    work.mkdir(parents=True, exist_ok=True)
    flag = [*FLAGSHIP_OVERRIDES, *MESH_DEPTH, *EP_OVER, *EP_CLI]
    cli = ["--seed", str(seed), "--device", "cuda"]
    cards = torch.cuda.device_count()
    E = flagship_moe().model.moe_experts
    # name, ranks, sharing card 0, mesh, data-parallel ways
    groups = [("gloo", 2, True, ("mesh.ep=2",), 2)]
    if cards >= 2:
        groups.append(("nccl", 2, False, ("mesh.ep=2",), 2))
    if cards >= 4:
        groups.append(("nccl_dp2", 4, False, ("mesh.ep=2", "mesh.dp=2"), 4))
    print("ep phase: " + "; ".join(f"{g}: {n} ranks, {' '.join(m)}"
                                   f"{' sharing card 0' if shared else ''}"
                                   for g, n, shared, m, _ in groups)
          + ("" if cards >= 4 else f" (the host has {cards} card(s): "
             + ("no NCCL run" if cards < 2 else "no dp=2 ep=2 run") + ")"))
    res: dict = {"train": {}, "train_cli": {}, "decode_cli": {}, "launches_by_path": {}}

    def train_over(run_dir: Path, steps: int, ways: int, *extra: str) -> list[str]:
        return [*cli, *flag, "data.synthetic=true", "data.synthetic_size=10",
                "training.grad_accum_steps=1", "training.save_every_steps=0",
                f"data.batch_size={EP_CLI_BATCH * ways}", "runtime.compute_dtype=float32",
                f"training.max_steps={steps}", f"training.checkpoint_dir={run_dir}", *extra]

    def dec_over(out: Path, *extra: str) -> list[str]:
        return [*cli, *flag, "data.synthetic=true", "data.synthetic_size=40",
                f"decode.max_new_tokens={MESH_DECODE_TOKENS}", "decode.batch_size=8",
                "runtime.compute_dtype=float32", f"decode.output_dir={out}", *extra]

    def one_card(tag: str, fn):
        torch.cuda.synchronize()
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        res["launches_by_path"][f"ep_{tag}"] = counts()
        settle()
        return out

    def rel(a, b) -> float:
        """||a - b|| / ||b||."""
        return float((a.double() - b.double()).norm() / b.double().norm().clamp(min=1e-30))

    def gate(tag: str, got: dict, want: dict, leaves: dict) -> dict:
        """The f32 gates against one process: loss |d| < 1e-5, grad norm,
        moe_lb and moe_z 1e-5 relative, the watched leaves (two LoRA ``b``,
        the connector's expert w1 and router) 1e-6 relative in norm."""
        dm = {k: max(abs(g[k] - w[k]) / (1.0 if k == "loss" else abs(w[k]))
                     for g, w in zip(got["metrics"], want["metrics"]))
              for k in ("loss", "grad_norm", "moe_lb", "moe_z")}
        dl = {k: rel(leaves[k], want["leaves"][k]) for k in want["leaves"]}
        check(all(v < 1e-5 for v in dm.values()) and all(v <= 1e-6 for v in dl.values()),
              f"ep {tag} against one process: {dm}, leaves {dl}")
        return dict(metric_diffs=dm, leaf_rel_diffs=dl)

    try:
        # ---- one process: the references --------------------------------------
        ref_train, ref_cli = {}, {}
        for ways in sorted({g[4] for g in groups}):
            for name, rows, d, n in EP_TRAIN:
                ref_train[name, ways] = one_card(
                    f"train_{name}_B{rows * ways}_one_card",
                    lambda rows=rows, d=d, n=n, ways=ways: mesh_train_run(
                        rows * ways, d, EP_OVER, n, bucket=EP_BUCKET))
            run1 = work / f"train_one_{ways}"
            rc = one_card(f"train_cli_B{EP_CLI_BATCH * ways}_one_card",
                          lambda run1=run1, ways=ways: train.main(train_over(run1, 2, ways)))
            check(rc == 0, f"one-card train CLI returned {rc}")
            ref_cli[ways] = [float(r[3]) for r in loss_rows(run1) if r[2] == "train"]
            shutil.rmtree(run1 / "ckpt", ignore_errors=True)
        ref_sp = one_card("train_sp_f32_B1_one_card",
                          lambda: mesh_train_run(1, "float32", (*EP_OVER, *MESH_DEPTH), 1,
                                                 bucket=EP_SP_BUCKET))
        rc = one_card("decode_cli_one_card", lambda: decode.main(dec_over(work / "dec1")))
        check(rc == 0, f"one-card decode CLI returned {rc}")
        ref_hyps = hyp_lines(work / "dec1")

        # ---- the ranks -----------------------------------------------------------
        reports = {}
        for group, world, shared, mesh, ways in groups:
            runs = [dict(kind="train", name=f"train_{n}", B=rows * ways, dtype=d,
                         mesh=[*EP_OVER, *mesh], steps=k, bucket=list(EP_BUCKET))
                    for n, rows, d, k in EP_TRAIN]
            if world == 2:
                runs.append(dict(kind="train", name="train_sp_f32", B=1, dtype="float32",
                                 mesh=[*EP_OVER, *EP_SP], steps=1, bucket=list(EP_SP_BUCKET)))
            runs.append(dict(kind="cli", name="train_cli", cli="train",
                             argv=train_over(work / f"train_{group}", 1, ways, *mesh)))
            runs.append(dict(kind="cli", name="decode_cli", cli="decode",
                             argv=dec_over(work / f"dec_{group}", *mesh)))
            runs.append(dict(kind="cli", name="decode_cli_preset", cli="decode",
                             argv=dec_over(work / f"dec_preset_{group}", *mesh,
                                           *PRESET_OVERRIDES)))
            reports[group] = spawn_ranks(dict(tag=f"ep_{group}", runs=runs), work, world, shared)

        for group, reps in reports.items():
            ways = next(g[4] for g in groups if g[0] == group)
            check(reps[0]["backend"] == ("gloo" if group == "gloo" else "nccl"),
                  f"{group} ranks ran {reps[0]['backend']}")
            takes = reps[0]["backend_takes"]
            print(f"ep {group}: ranks on {[r['device'] for r in reps]}; the backend takes "
                  f"on CUDA tensors {json.dumps(takes)}")
            check(all(v == "yes" for v in takes.values()),
                  f"{group} refuses a collective the port makes on CUDA tensors: {takes}")
            leaves = torch.load(work / f"ep_{group}_leaves.pt")
            trains = [(f"train_{n}", n, rows, d, k, ref_train[n, ways], EP_OVER)
                      for n, rows, d, k in EP_TRAIN]
            if len(reps) == 2:
                trains.append(("train_sp_f32", "sp_f32", 1, "float32", 1, ref_sp,
                               (*EP_OVER, *MESH_DEPTH)))
            for name, n, rows, dtype, steps, want, over in trains:
                runs_r = [r["runs"][name] for r in reps]
                got = runs_r[0]
                mesh_ways = int(np.prod([got["mesh"][a] for a in ("dcn", "dp", "fsdp", "ep")]))
                row = dict(mesh=got["mesh"], global_batch=got["rows"] * mesh_ways,
                           loss=[m["loss"] for m in got["metrics"]],
                           moe_lb=[m["moe_lb"] for m in got["metrics"]],
                           moe_z=[m["moe_z"] for m in got["metrics"]],
                           step_ms=[r["step_ms"] for r in runs_r],
                           peak_gb=[r["peak_gb"] for r in runs_r],
                           one_card_step_ms=want["step_ms"], one_card_peak_gb=want["peak_gb"],
                           dropped=[r["moe_dropped"] for r in runs_r],
                           one_card_dropped=want["moe_dropped"],
                           experts_per_rank=runs_r[0]["experts"],
                           launches=[r["launches"] for r in runs_r])
                check(all(r["metrics"] == got["metrics"] for r in runs_r),
                      f"ep {group} {name}: the ranks report different metrics")
                ep = got["mesh"]["ep"]
                for r, rr in enumerate(runs_r):
                    check(rr["experts"] and all(sh[0] == E // ep for sh in rr["experts"].values()),
                          f"ep {group} {name} rank {r} holds experts {rr['experts']}")
                    check(rr["moe_dropped"] > 0,
                          f"ep {group} {name} rank {r}: no assignment dropped")
                    cfg = mesh_cfg(dtype, over)
                    per_step = (sp_train_launches(cfg, rr["sp_rank"], 2) if n == "sp_f32"
                                else pp_train_launches(cfg, rows, ways))
                    exact = {k: v * steps for k, v in per_step.items()}
                    check(rr["launches"] == exact,
                          f"ep {group} {name} rank {r}: launches {rr['launches']}, "
                          f"expected {exact}")
                    res["launches_by_path"][f"ep_{group}_{name}_rank{r}"] = rr["launches"]
                if dtype == "float32":
                    row.update(gate(f"{group} {name}", got, want, leaves[name]))
                res["train"][f"{group}_{n}"] = row
                print(f"ep {group} {n}: " + json.dumps(row))

            # ---- the train CLI: 1 step on the ranks, a second at world 1 -----
            run2 = work / f"train_{group}"
            tl = [r["runs"]["train_cli"] for r in reps]
            check(all(t["rc"] == 0 for t in tl), f"ep {group} train CLI ranks returned "
                                                  f"{[t['rc'] for t in tl]}")
            rc = one_card(f"train_cli_{group}_resumed",
                          lambda: train.main(train_over(run2, 2, ways)))
            check(rc == 0, f"ep {group}: the world-1 resume returned {rc}")
            got = [float(r[3]) for r in loss_rows(run2) if r[2] == "train"]
            shutil.rmtree(run2 / "ckpt", ignore_errors=True)
            want = ref_cli[ways]
            d = max(abs(a - b) / abs(b) for a, b in zip(got, want))
            row = dict(ranks_then_resumed=got, one_card=want, max_rel_diff=d,
                       seconds=[t["seconds"] for t in tl])
            res["train_cli"][group] = row
            print(f"ep {group} train CLI: " + json.dumps(row))
            check(len(got) == len(want) == 2 and d < 1e-5,
                  f"ep {group} train CLI losses {got}, one card {want}")
            for r, t in enumerate(tl):
                res["launches_by_path"][f"ep_{group}_train_cli_rank{r}"] = t["launches"]
                check(t["launches"]["flash_fwd"] and t["launches"]["flash_bwd_dq"]
                      and t["launches"]["flash_bwd_dkv"],
                      f"ep {group} train CLI rank {r}: {t['launches']}")

            # ---- the decode CLI: f32 hypotheses, the preset's kernels --------
            for tag in ("decode_cli", "decode_cli_preset"):
                dl_ = [r["runs"][tag] for r in reps]
                check(all(x["rc"] == 0 for x in dl_), f"ep {group} {tag} ranks returned "
                                                      f"{[x['rc'] for x in dl_]}")
                row = dict(seconds=[x["seconds"] for x in dl_],
                           launches=[x["launches"] for x in dl_])
                for r, x in enumerate(dl_):
                    res["launches_by_path"][f"ep_{group}_{tag}_rank{r}"] = x["launches"]
                    lc = x["launches"]
                    check(lc["flash_fwd"] and (tag == "decode_cli" or (
                        lc["qmatmul_int4"] and lc["qmatmul_int8"])),
                        f"ep {group} {tag} rank {r}: {lc}")
                if tag == "decode_cli":
                    two = hyp_lines(work / f"dec_{group}")
                    row.update(equal_hyps=two == ref_hyps, lines=len(two))
                    check(len(two) == 8 and two == ref_hyps,
                          f"ep {group} decode CLI: HYP lines differ from the one-card decode")
                res["decode_cli"][f"{group}_{tag}"] = row
                print(f"ep {group} {tag}: " + json.dumps(row))
        res["backend_takes"] = {g: reps[0]["backend_takes"] for g, reps in reports.items()}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    check(not work.exists(), f"{work} not removed")
    res["seconds"] = time.perf_counter() - t_all
    print(f"ep phase: {res['seconds']:.1f} s; launches " + json.dumps(res["launches_by_path"]))
    return res


# ---------------------------------------------------------------------------
# Phase 26: the flash kernels at every head width, and Llama-2-7B with the
# attention connector at full width
# ---------------------------------------------------------------------------

# The reference's other LLM, Llama-2-7B (MHA with heads of 128, an untied
# head, vocab 32000, plain RoPE at theta 1e4), with the ``attention``
# connector, whose 8 heads over the 4096-wide LLM are 512 wide: the flagship
# through the JAX CLI's dotted overrides.
LLAMA2_OVERRIDES = ("model.llm.vocab_size=32000", "model.llm.d_model=4096",
                    "model.llm.n_layers=32", "model.llm.n_heads=32", "model.llm.n_kv_heads=32",
                    "model.llm.ffn_dim=11008", "model.llm.rope_theta=10000.0",
                    "model.llm.rms_eps=1e-5", "model.llm.tie_embeddings=false",
                    "model.llm.max_seq_len=4096", "model.connector_type=attention")
# phase 21's quarter depth, with a quarter of the 7B's 32 blocks (every run
# of phase 26 since phase 27 runs the same MHA D = 128 kernels at full depth)
LLAMA2_QUARTER = ("model.whisper.n_layers=6", "model.clip.n_layers=3", "model.llm.n_layers=8")
# Llama-2-13B (meta-llama/Llama-2-13b-hf's config.json: 5120 wide, 40 blocks
# of 40 MHA heads of 128, ffn 13824, vocab 32000, an untied head, theta 1e4)
# with the ``attention`` connector, whose 8 heads over the 5120-wide LLM are
# 640 wide (the panel kernels): phase 27.
LLAMA2_13B_OVERRIDES = ("model.llm.vocab_size=32000", "model.llm.d_model=5120",
                        "model.llm.n_layers=40", "model.llm.n_heads=40",
                        "model.llm.n_kv_heads=40", "model.llm.ffn_dim=13824",
                        "model.llm.rope_theta=10000.0", "model.llm.rms_eps=1e-5",
                        "model.llm.tie_embeddings=false", "model.llm.max_seq_len=4096",
                        "model.connector_type=attention")
# phase 27's f32 check: 6 Whisper, 3 CLIP and 10 of the 13B's 40 blocks
LLAMA2_13B_REDUCED = ("model.whisper.n_layers=6", "model.clip.n_layers=3",
                      "model.llm.n_layers=10")
# Llama-2-70B's width: its connectors' 8 heads are 1024 wide. One card
# cannot hold the 70B in bf16, so phase 27 runs its connector alone.
LLAMA2_70B_WIDTH = 8192
# the head widths held to the plain versions at small shapes: every
# multiple of 64 through 512 (192-448 by the pad route), and above 512
# the panel kernels at 576, 640 (the 13B's connectors), 768, 896, 1024
# (the 70B's) and 2048 (the bf16 forward on a cluster of 3-8 CTAs), and
# 2112 (9 column groups, past the largest cluster: the bf16 forward on the
# per-group panel kernel)
WIDTHS_CHECKED = (*range(64, 513, 64), 576, 640, 768, 896, 1024, 2048, 2112)
# the pad route's forward (the next wider kernel at the operands' own
# width) at the connectors' shape [8, 8, 500, D]: Llama-3.2-3B's heads of
# 384 and the other widths between the compiled ones
PAD_ROUTE_WIDTHS = (192, 320, 384, 448)
# the flash shapes of phases 26 and 27 (name: B, H, Hkv, T, valid rows,
# causal, D): the 7B's prefill and train step (MHA, heads of 128), its
# connectors' attention (8 heads of 512 over the 500 Whisper rows), the pad
# route at 384 (Llama-3.2-3B's connectors: the D = 512 kernels on
# zero-padded operands), the 13B's prefill and train step (40 heads of 128)
# and the panel kernels at the 13B's and the 70B's connectors (640, 1024),
# at 896 (a last column group of two panels) and at 2048 (B = 2); the
# panel shapes are held in f32 too
WIDTH_SHAPES = {"llm2_prefill": (8, 32, 32, 533, 533, True, 128),
                "llm2_train": (8, 32, 32, 672, 581, True, 128),
                "connector512": (8, 8, 8, 500, 500, False, 512),
                "connector384": (8, 8, 8, 500, 500, False, 384),
                "llm13_prefill": (8, 40, 40, 533, 533, True, 128),
                "llm13_train": (8, 40, 40, 672, 581, True, 128),
                "connector640": (8, 8, 8, 500, 500, False, 640),
                "connector896": (8, 8, 8, 500, 500, False, 896),
                "connector1024": (8, 8, 8, 500, 500, False, 1024),
                "panels2048": (2, 8, 8, 500, 500, False, 2048)}
# the 7B's and the 13B's decode products at M = 8 (name, bits, K, N): q|k|v,
# o, gate|up, down in int4 (the preset) and the int8 head over the vocab
# padded to a multiple of 2048 (ops/quant.py::quantize_llm)
LLAMA2_QMM = (("qkv", 4, 4096, 12288), ("o", 4, 4096, 4096), ("gateup", 4, 4096, 22016),
              ("down", 4, 11008, 4096), ("lm_head", 8, 4096, 32768))
LLAMA2_13B_QMM = (("qkv", 4, 5120, 15360), ("o", 4, 5120, 5120),
                  ("gateup", 4, 5120, 27648), ("down", 4, 13824, 5120),
                  ("lm_head", 8, 5120, 32768))


def flagship_llama2(extra=()):
    """The flagship with Llama-2-7B and the ``attention`` connector."""
    from avsr_tpu_torch.core.config import flagship

    return flagship([*LLAMA2_OVERRIDES, *extra])


def flagship_llama2_13b(extra=()):
    """The flagship with Llama-2-13B and the ``attention`` connector."""
    from avsr_tpu_torch.core.config import flagship

    return flagship([*LLAMA2_13B_OVERRIDES, *extra])


def _flash_case(A, q, k, v, do, ql, kl, causal: bool, tol: float, tag: str) -> dict:
    """The forward, dQ and dK/dV wrappers against their plain versions on
    one set of operands: max|d| / max|ref| of O and the three gradients,
    lse (+inf rows equal, atol ``tol`` / 10 in bf16), delta; returns the
    relative errors."""
    import torch

    o, lse = A.flash_attention(q, k, v, ql, kl, causal)
    o_r, lse_r = A.flash_attention_reference(q, k, v, ql, kl, causal)
    dq, delta = A.flash_bwd_dq(q, k, v, o, lse, do, ql, kl, causal)
    dk, dv = A.flash_bwd_dkv(q, k, v, lse, delta, do, ql, kl, causal)
    refs = A.flash_attention_bwd_reference(q, k, v, o, lse, do, ql, kl, causal)
    delta_r = A.flash_bwd_dq_reference(q, k, v, o, lse, do, ql, kl, causal)[1]
    torch.cuda.synchronize()
    errs = {}
    for name, got, ref in zip(("o", "dq", "dk", "dv"), (o, dq, dk, dv), (o_r, *refs)):
        check(got.shape == ref.shape and bool(torch.isfinite(got.float()).all()),
              f"{tag}: {name} {tuple(got.shape)} not finite or not {tuple(ref.shape)}")
        errs[name] = rel_err(got, ref)
        check(errs[name] <= tol, f"{tag}: {name} max|d| {errs[name]:.3e} x max|ref| > {tol}")
    fin = torch.isfinite(lse_r)
    check(torch.equal(fin, torch.isfinite(lse)), f"{tag}: lse +inf rows differ")
    le = (lse[fin] - lse_r[fin]).abs().max().item() if bool(fin.any()) else 0.0
    check(le <= max(tol / 10, 1e-4), f"{tag}: lse off by {le:.3e}")
    de = (delta - delta_r).abs().max().item()
    check(de <= 1e-4 * max(1.0, delta_r.abs().max().item()), f"{tag}: delta off by {de:.3e}")
    errs["lse_abs"] = le
    return errs


def width_kernel_rows(seed: int) -> dict:
    """The flash forward, dQ and dK/dV at every head width of
    ``WIDTHS_CHECKED`` (every multiple of 64 through 512, and the panel
    kernels above it), each held to its plain version in bf16 (2e-2 x
    max|ref|) and f32 (1e-4): causal GQA 2:1 over ragged rows, and
    non-causal MHA with Tq != Tk and a row without keys. Then at each of
    ``WIDTH_SHAPES`` (bf16, main-path lengths; above 512 in f32 too): the
    same checks, and the kernels timed from replayed CUDA graphs beside
    their bound, their plain versions (eager) and SDPA (with the backend it
    took), with the bf16 forward's cluster size; at 384 also the pad copies
    the forward no longer makes and those the backward still makes. Then
    ``pad_route_rows``."""
    import torch

    from avsr_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(seed + 2600)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda", dtype=dtype)

    def lens(*n):
        return torch.tensor(n, dtype=torch.int32, device="cuda")

    widths: dict = {}
    for D in WIDTHS_CHECKED:
        check(A.kernel_takes(D), f"the kernels do not take head width {D}")
        worst = {}
        for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
            for case, (H, Hkv, Tq, Tk, causal, ql, kl) in {
                    "causal_gqa": (4, 2, 300, 300, True, (300, 217), (300, 217)),
                    "cross_mha_empty": (4, 4, 300, 290, False, (300, 131), (290, 0))}.items():
                q, do = randn(2, H, Tq, D, dtype=dt), randn(2, H, Tq, D, dtype=dt)
                k, v = randn(2, Hkv, Tk, D, dtype=dt), randn(2, Hkv, Tk, D, dtype=dt)
                tag = f"D={D} {case} {str(dt)[6:]}"
                e = _flash_case(A, q, k, v, do, lens(*ql), lens(*kl), causal, tol, tag)
                key = str(dt)[6:]
                worst[key] = max(worst.get(key, 0.0), *(e[n] for n in ("o", "dq", "dk", "dv")))
        widths[D] = dict(kernel_width=A.kernel_width(D), max_rel_err=worst)
    print("kernel widths: forward, dQ and dK/dV held to their plain versions at "
          + "; ".join(f"D={D} (kernel {w['kernel_width']}) bf16 {w['max_rel_err']['bfloat16']:.2e}"
                      f" f32 {w['max_rel_err']['float32']:.2e}" for D, w in widths.items()))

    rows = {}
    for name, (B, H, Hkv, T, n, causal, D) in WIDTH_SHAPES.items():
        q, do = randn(B, H, T, D), randn(B, H, T, D)
        k, v = randn(B, Hkv, T, D), randn(B, Hkv, T, D)
        ln = lens(*[n] * B)
        ragged = lens(*[n, n // 2, 1, n, 0, T, n - 7, 17][:B])
        err = _flash_case(A, q, k, v, do, ln, ln, causal, 2e-2, f"{name} main")
        err_r = _flash_case(A, q, k, v, do, ragged, ragged, causal, 2e-2, f"{name} ragged")
        o, lse = A.flash_attention(q, k, v, ln, ln, causal)
        args_dq = (q, k, v, o, lse, do, ln, ln, causal)
        _, delta = A.flash_bwd_dq(*args_dq)
        args_dkv = (q, k, v, lse, delta, do, ln, ln, causal)
        times = {"fwd": graph_ms([lambda: A.flash_attention(q, k, v, ln, ln, causal)]),
                 "dq": graph_ms([lambda: A.flash_bwd_dq(*args_dq)]),
                 "dkv": graph_ms([lambda: A.flash_bwd_dkv(*args_dkv)])}
        plain = {"fwd": time_ms(lambda: A.flash_attention_reference(q, k, v, ln, ln, causal), 3),
                 "dq": time_ms(lambda: A.flash_bwd_dq_reference(*args_dq), 3),
                 "dkv": time_ms(lambda: A.flash_bwd_dkv_reference(*args_dkv), 3)}
        lib = {"fwd": sdpa_ms(q, k, v, ln, causal), "bwd": sdpa_ms(q, k, v, ln, causal, do)}
        bounds = attn_bounds(q, k, ln, ln, causal)
        row = dict(q=list(q.shape), kv=list(k.shape), causal=causal, lens=n,
                   kernel_width=A.kernel_width(D), max_rel_err=err,
                   ragged_max_rel_err=err_r, library_bwd_pair=lib["bwd"])
        for kname in ("fwd", "dq", "dkv"):
            ops_ms, bytes_ms = bounds[kname]
            lb = lib["fwd" if kname == "fwd" else "bwd"]
            row[kname] = dict(ms=times[kname], plain_ms=plain[kname], library_ms=lb["ms"],
                              library_backend=lb["backend"],
                              bound_ms=max(ops_ms, bytes_ms), ops_ms=ops_ms, bytes_ms=bytes_ms,
                              bound_by="operations" if ops_ms >= bytes_ms else "bytes")
        if A.kernel_width(D) != D:
            # the copies the bf16 forward no longer makes (q, k, v) and
            # those the backward still makes (dQ: q, k, v, O, dO; dK/dV:
            # q, k, v, dO)
            Dp = A.kernel_width(D)
            row["fwd_pad_ms"] = graph_ms([lambda: A._pad_heads(Dp, q, k, v)])
            row["bwd_pad_ms"] = graph_ms([lambda: A._pad_heads(Dp, q, k, v, o, do),
                                          lambda: A._pad_heads(Dp, q, k, v, do)])
        row["cluster"] = A.kernel_cluster(D, torch.bfloat16)
        del o, lse, delta, args_dq, args_dkv
        if D > A.COMPILED_HEAD_DIMS[-1]:
            # the f32 panel kernels at the same shape and lengths
            q, k, v, do = (t.float() for t in (q, k, v, do))
            row["f32_max_rel_err"] = _flash_case(A, q, k, v, do, ln, ln, causal, 1e-4,
                                                 f"{name} f32")
        rows[name] = row
        print(f"kernel {name} {row['q']} over {row['kv']} ({'causal' if causal else 'non-causal'}, "
              f"{n} rows, {gpu_line()}): "
              + "; ".join(f"{kn} {times[kn]:.4f} ms (plain {plain[kn]:.4f}, SDPA "
                          f"{row[kn]['library_ms']:.4f} by {row[kn]['library_backend']}, "
                          f"bound {row[kn]['bound_ms']:.4f} by {row[kn]['bound_by']})"
                          for kn in ("fwd", "dq", "dkv"))
              + (f"; cluster of {row['cluster']}" if row["cluster"] else "")
              + (f"; the pad copies the forward no longer makes {row['fwd_pad_ms']:.4f} ms,"
                 f" the backward's {row['bwd_pad_ms']:.4f} ms"
                 if "fwd_pad_ms" in row else "")
              + f"; max|d|/max|ref| {err}"
              + (f"; f32 {row['f32_max_rel_err']}" if "f32_max_rel_err" in row else ""))
        del q, k, v, do
    return dict(widths=widths, shapes=rows, pad_route=pad_route_rows(gen))


def pad_route_rows(gen) -> dict:
    """The bf16 forward at each of ``PAD_ROUTE_WIDTHS`` on [8, 8, 500, D]
    (the next wider compiled kernel at the operands' own width): no copy
    (``pad_copies`` unchanged), O and lse bit for bit those of the compiled
    kernel run on operands zero-padded by hand, and its time from a
    replayed CUDA graph beside bound, plain version and SDPA, with the time
    of the copies it no longer makes."""
    import torch

    from avsr_tpu_torch.ops import attention as A

    rows = {}
    for D in PAD_ROUTE_WIDTHS:
        q, k, v = (torch.randn((8, 8, 500, D), generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(3))
        ln = torch.full((8,), 500, dtype=torch.int32, device="cuda")
        Dp = A.kernel_width(D)
        before = A.pad_copies
        o, lse = A.flash_attention(q, k, v, ln, ln, False)
        copies = A.pad_copies - before
        o_p, lse_p = A.flash_attention(*A._pad_heads(Dp, q, k, v), ln, ln, False, D ** -0.5)
        torch.cuda.synchronize()
        check(copies == 0, f"pad route D={D}: the bf16 forward made {copies} pad copies")
        check(torch.equal(o, o_p[..., :D]) and torch.equal(lse, lse_p),
              f"pad route D={D}: O or lse differ from the padded kernel's")
        o_r = A.flash_attention_reference(q, k, v, ln, ln, False)[0]
        err = rel_err(o, o_r)
        check(err <= 2e-2, f"pad route D={D}: O max|d| {err:.3e} x max|ref|")
        ops_ms, bytes_ms = attn_bounds(q, k, ln, ln, False)["fwd"]
        lib = sdpa_ms(q, k, v, ln, False)
        rows[D] = dict(shape=list(q.shape), kernel_width=Dp, bit_equal_to_padded=True,
                       pad_copies=copies, max_rel_err=err,
                       ms=graph_ms([lambda: A.flash_attention(q, k, v, ln, ln, False)]),
                       plain_ms=time_ms(lambda: A.flash_attention_reference(q, k, v, ln, ln,
                                                                            False), 3),
                       library_ms=lib["ms"], library_backend=lib["backend"],
                       bound_ms=max(ops_ms, bytes_ms),
                       bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                       avoided_pad_ms=graph_ms([lambda: A._pad_heads(Dp, q, k, v)]))
        del q, k, v, o, lse, o_p, lse_p, o_r
    print(f"pad route forward, [8, 8, 500, D], no copy, bit-equal to the padded kernel "
          f"({gpu_line()}): "
          + "; ".join(f"D={D} (kernel {r['kernel_width']}) {r['ms']:.4f} ms (SDPA "
                      f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f}, plain "
                      f"{r['plain_ms']:.4f}; the copies it no longer makes "
                      f"{r['avoided_pad_ms']:.4f} ms)" for D, r in rows.items()))
    return rows


def llama2_runs(seed: int, tag: str, make_config, depth: tuple, f32_depth: tuple,
                qmm: tuple, seed_offset: int) -> tuple[dict, dict]:
    """``make_config(extra overrides)``'s flagship (a Llama-2 LLM and the
    ``attention`` connector), random bf16 weights from ``seed`` made on the
    card, with ``depth`` overrides on top: a static bf16 call (B = 8, 10 s,
    25 frames, 32 tokens), a train step of 8 (accum 1) after a warm-up step
    and the same two steps again from the same state (bit-equal), the
    serving preset's call; in f32 at ``f32_depth`` the kernel path's prefill logits
    and 16 greedy tokens against the plain path's; and the decode products
    ``qmm`` at M = 8. Launches exact, derived from the widths. Returns
    (results, launches by path, each path named ``tag``_...)."""
    import torch

    from avsr_tpu_torch.cli.common import load_decode_params
    from avsr_tpu_torch.convert import param_count
    from avsr_tpu_torch.data.loader import featurize
    from avsr_tpu_torch.data.tokenizer import ByteTokenizer
    from avsr_tpu_torch.infer.generate import generate_tokens
    from avsr_tpu_torch.models.avsr import init_avsr_model
    from avsr_tpu_torch.ops.quant import quant_bytes
    from avsr_tpu_torch.train.state import cast_frozen, create_train_state, path_leaves
    from avsr_tpu_torch.train.step import make_train_step

    res: dict = {}
    by_path: dict[str, dict[str, int]] = {}

    def counted(path: str, fn):
        torch.cuda.synchronize()
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        by_path[f"{tag}_{path}"] = counts()
        return out

    def want(flash=0, dq=0, dkv=0, int8=0, int4=0) -> dict[str, int]:
        return dict(flash_fwd=flash, flash_bwd_dq=dq, flash_bwd_dkv=dkv, qmatmul_int8=int8,
                    qmatmul_int4=int4)

    cfg = make_config(depth)
    mc = cfg.model
    nW, nL, width = mc.whisper.n_layers, mc.llm.n_layers, mc.llm.d_model
    tok = ByteTokenizer()
    hb = serving_host_batch(cfg, seed)
    B = len(hb.utt_ids)
    d = connector_launches("attention", 500, hb.prompt.shape[1], cfg.data.max_label_length,
                           nW, nL)

    # ---- a static bf16 call (B = 8, 10 s, 25 frames, 32 tokens) ----------
    t0 = time.perf_counter()
    params = init_avsr_model(mc, seed=seed, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = param_count(params)
    res["init_s"] = time.perf_counter() - t0
    print(f"{tag}: random init of {n_params / 1e9:.3f} B params (bf16; LLM "
          f"{param_count(params['llm']) / 1e9:.3f} B, {nL} blocks) in {res['init_s']:.2f} s")
    check(tuple(params["llm"]["lm_head"]["w"].shape) == (width, 32000),
          f"{tag}: the untied head is not [{width}, 32000]")
    batch = featurize(hb, "cuda", torch.bfloat16)
    kw = dict(max_new_tokens=32, eos_id=-1, compute_dtype=torch.bfloat16)
    generate_tokens(params, mc, batch, **{**kw, "max_new_tokens": 2})       # warm-up
    torch.cuda.reset_peak_memory_stats()
    st: dict = {}
    out = counted("generate", lambda: generate_tokens(params, mc, batch, stats=st, **kw))
    peak = torch.cuda.max_memory_allocated() / 1e9
    w = want(*d["generate"].values())
    check(by_path[f"{tag}_generate"] == w,
          f"{tag} generate launches {by_path[f'{tag}_generate']}, expected {w}")
    check(out.tokens.shape == (B, 32) and bool((out.lengths == 32).all())
          and bool(((out.tokens >= 0) & (out.tokens < mc.llm.vocab_size)).all()),
          f"{tag} tokens {tuple(out.tokens.shape)}")
    check(st["prefill_logits"].shape[-1] == 32000
          and bool(torch.isfinite(st["prefill_logits"]).all()), f"{tag} prefill logits")
    res["static_bf16"] = dict(
        encode_ms=st["encode_s"] * 1e3, prefill_ms=st["prefill_s"] * 1e3,
        ms_per_token=st["decode_s"] * 1e3 / st["decode_steps"], peak_mem_gb=peak,
        params_b=n_params / 1e9, llm_blocks=nL, launches=w)
    print(f"{tag} static bf16: " + json.dumps(res["static_bf16"]))

    # ---- a bf16 train step of 8, and the same step again from the same state
    tcfg = make_config((*depth, "training.grad_accum_steps=1"))
    micro = featurize(train_host_batch(tcfg, tok, np.random.default_rng(seed + seed_offset)),
                      "cuda", torch.bfloat16)
    stacked = _stack([micro])
    # two trees of the same values: the trainable leaves (connectors, LoRA)
    # in f32 each, the frozen bf16 leaves shared
    ta, tb = cast_frozen(params, mc, torch.bfloat16), cast_frozen(params, mc, torch.bfloat16)
    state_a, tr = _run_steps(tcfg, ta, stacked, 2, f"{tag} train", seed,
                             expect=want(*d["train_step"].values()))
    by_path[f"{tag}_train_2_steps"] = {k: sum(s_["launches"][k] for s_ in tr["steps"])
                                       for k in counts()}
    state_b = create_train_state(tb, tcfg, total_steps=1000)
    step = make_train_step(tcfg)
    m_b = [step(state_b, stacked, seed + i) for i in range(2)]
    for i, s_ in enumerate(tr["steps"]):
        check(all(s_[k] == m_b[i][k] for k in ("loss", "grad_norm")),
              f"{tag} train step {i + 1} repeated: {m_b[i]} != {s_}")
    la, lb = path_leaves(state_a.state_dict()), path_leaves(state_b.state_dict())
    diff = [k for k, v in la.items() if isinstance(v, torch.Tensor) and not torch.equal(v, lb[k])]
    check(not diff, f"{tag} train steps from one state differ in {diff[:5]}")
    res["train_bf16"] = dict(
        step_ms=tr["steps"][-1]["ms"], first_step_ms=tr["steps"][0]["ms"],
        peak_mem_gb=tr["peak_mem_gb"], loss=tr["steps"][-1]["loss"],
        split_ms={k: v for k, v in tr["steps"][-1].items() if k.endswith("_ms")},
        repeated_step_bit_equal=True, launches_per_step=tr["steps"][-1]["launches"])
    print(f"{tag} train bf16: " + json.dumps(res["train_bf16"]))
    # the bf16 tree goes before the preset's f32 init
    del ta, tb, state_a, state_b, step, m_b, la, lb, params, out, st, stacked, micro
    settle()

    # ---- the serving preset's call -----------------------------------------
    pcfg = make_config((*depth, *PRESET_OVERRIDES))
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    pp = load_decode_params(pcfg, seed=seed, device="cuda")
    torch.cuda.synchronize()
    load_peak = torch.cuda.max_memory_allocated() / 1e9
    llm_gb = quant_bytes(pp["llm"]) / 1e9
    print(f"{tag} preset: f32 init, int4 quantization, bf16 cast and decode layout in "
          f"{time.perf_counter() - t0:.2f} s (peak {load_peak:.2f} GB); LLM tree "
          f"{llm_gb:.3f} GB")
    pkw = dict(kw, kv_cache_dtype=pcfg.decode.kv_cache_dtype)
    generate_tokens(pp, pcfg.model, batch, **{**pkw, "max_new_tokens": 2})   # warm-up
    torch.cuda.reset_peak_memory_stats()
    st = {}
    out = counted("preset", lambda: generate_tokens(pp, pcfg.model, batch, stats=st, **pkw))
    peak = torch.cuda.max_memory_allocated() / 1e9
    steps = st["decode_steps"]
    w = want(flash=d["generate"]["fwd"], int8=steps + 1, int4=4 * nL * steps)
    check(by_path[f"{tag}_preset"] == w,
          f"{tag} preset launches {by_path[f'{tag}_preset']}, expected {w}")
    check(out.tokens.shape == (B, 32) and bool(torch.isfinite(st["prefill_logits"]).all())
          and bool(((out.tokens >= 0) & (out.tokens < 32000)).all()), f"{tag} preset tokens")
    res["preset"] = dict(
        encode_ms=st["encode_s"] * 1e3, prefill_ms=st["prefill_s"] * 1e3,
        ms_per_token=st["decode_s"] * 1e3 / steps, peak_mem_gb=peak, load_peak_mem_gb=load_peak,
        llm_tree_gb=llm_gb, launches=w)
    print(f"{tag} preset: " + json.dumps(res["preset"]))
    del pp, out, st
    settle()

    # ---- f32 at full width and reduced depth: kernels vs plain -------------
    qcfg = make_config(f32_depth)
    qmc = qcfg.model
    p32 = init_avsr_model(qmc, seed=seed, device="cuda", dtype=torch.float32)
    b32 = featurize(hb, "cuda", torch.float32)
    kw32 = dict(max_new_tokens=16, eos_id=-1, compute_dtype=torch.float32)
    s_k: dict = {}
    s_n: dict = {}
    out_k = counted("f32", lambda: generate_tokens(p32, qmc, b32, stats=s_k, **kw32))
    qd = connector_launches("attention", 500, hb.prompt.shape[1], 0, qmc.whisper.n_layers,
                            qmc.llm.n_layers)
    check(by_path[f"{tag}_f32"] == want(qd["generate"]["fwd"]),
          f"{tag} f32 launches {by_path[f'{tag}_f32']}")
    out_n = generate_tokens(p32, qmc, b32, stats=s_n, use_kernel="never", **kw32)
    lk, ln_ = s_k["prefill_logits"], s_n["prefill_logits"]
    std = ln_.std().item()
    dmax = (lk - ln_).abs().max().item()
    check(dmax <= 2e-2 * std, f"{tag} f32 prefill logits: kernel vs plain max|d| {dmax:.4e} "
                              f"> 2e-2 * std {std:.4e}")
    check(torch.equal(out_k.tokens, out_n.tokens),
          f"{tag} f32: tokens with the kernels differ from the plain path's")
    res["f32"] = dict(std=std, kernel_vs_plain_max=dmax,
                      kernel_vs_plain_mean=(lk - ln_).abs().mean().item(),
                      tokens_equal=True, tokens=list(out_k.tokens.shape),
                      llm_blocks=qmc.llm.n_layers, launches=by_path[f"{tag}_f32"])
    print(f"{tag} f32 at {qmc.llm.n_layers} LLM blocks: " + json.dumps(res["f32"]))
    del p32, b32, out_k, out_n, s_k, s_n
    settle()

    # ---- the decode products at M = 8 --------------------------------------
    qgen = torch.Generator(device="cuda").manual_seed(seed + seed_offset + 1)
    res["qmm_rows"] = [
        qmm_row(f"{tag}_{name}", bits, 8, K, N,
                {f"{tag}_preset": nL * steps if bits == 4 else steps + 1}, qgen)
        for name, bits, K, N in qmm]
    return res, by_path


def llama2_phase(seed: int) -> dict:
    """Phase 26: the flash kernels at every head width, then
    ``flagship_llama2()`` at full width and ``LLAMA2_QUARTER``'s depth (see
    the module docstring), launches exact and derived from the widths."""
    t_all = time.perf_counter()
    res: dict = {"kernels": width_kernel_rows(seed)}
    runs, by_path = llama2_runs(seed, "llama2", flagship_llama2, LLAMA2_QUARTER,
                                LLAMA2_QUARTER, LLAMA2_QMM, 2601)
    res.update(runs, launches_by_path=by_path, seconds=time.perf_counter() - t_all)
    print(f"llama2 phase: {res['seconds']:.1f} s")
    return res


def connector70b_rows(seed: int) -> dict:
    """The ``attention`` connector at Llama-2-70B's width alone (Whisper's
    1024 features to 8192: 8 heads of 1024) over 8 x 500 ragged rows, in
    bf16 and f32: its output and the gradients of x and of every leaf
    through the kernels (one forward, dQ and dK/dV launch each) against the
    plain path (``use_kernel="never"``): max|d| / max|ref| of the output
    and of x's gradient, ||d|| / ||ref|| of each leaf's, within the
    kernels' gates (bf16 2e-2, f32 1e-4). The attention's key bias has an
    exact gradient of 0 (the softmax cancels it), so its max|d| is held to
    the gate times the value bias's max|g| instead."""
    import torch

    from avsr_tpu_torch.core.config import flagship
    from avsr_tpu_torch.models.connectors import get_connector

    conn = get_connector("attention")
    mc = flagship(["model.connector_type=attention"]).model
    out: dict = {}
    for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        name = str(dt)[6:]
        gen = torch.Generator(device="cuda").manual_seed(seed + 2701)
        params = conn.init(gen, 1024, LLAMA2_70B_WIDTH, mc, dtype=dt)
        x = torch.randn((8, 500, 1024), generator=gen, device="cuda", dtype=dt)
        lens = torch.tensor([500, 411, 500, 257, 500, 499, 380, 500], device="cuda")
        w = torch.randn((8, 500, LLAMA2_70B_WIDTH), generator=gen, device="cuda", dtype=dt)
        named = _named_leaves(params)
        leaves = [x, *named.values()]
        got = {}
        for use_kernel in ("auto", "never"):
            for t in leaves:
                t.requires_grad_(True)
            torch.cuda.synchronize()
            reset_counts()
            y, _ = conn.apply(params, x, lens, use_kernel=use_kernel)
            grads = torch.autograd.grad((y.float() * w.float()).sum(), leaves)
            torch.cuda.synchronize()
            got[use_kernel] = (y.detach(), [g.detach().float() for g in grads], counts())
        (y_k, g_k, n_k), (y_n, g_n, n_n) = got["auto"], got["never"]
        check(n_k["flash_fwd"] == n_k["flash_bwd_dq"] == n_k["flash_bwd_dkv"] == 1
              and not any(n_n.values()), f"70B connector {name} launches {n_k}, {n_n}")
        check(all(bool(torch.isfinite(t.float()).all()) for t in (y_k, *g_k)),
              f"70B connector {name}: not finite")
        grads_k = dict(zip(named, g_k[1:]))
        grads_n = dict(zip(named, g_n[1:]))
        leaf_err = {}
        for path, g in grads_k.items():
            ref = grads_n[path]
            if path[-2:] == ("k", "b"):
                vb = grads_n[path[:-2] + ("v", "b")].abs().max()
                leaf_err[path] = float((g - ref).abs().max() / vb)
            else:
                leaf_err[path] = float((g - ref).norm() / ref.norm())
        errs = dict(out=rel_err(y_k, y_n), dx=rel_err(g_k[0], g_n[0]),
                    leaves=max(leaf_err.values()),
                    worst_leaf="/".join(max(leaf_err, key=leaf_err.get)))
        check(max(errs["out"], errs["dx"], errs["leaves"]) <= tol,
              f"70B connector {name}: {errs} > {tol}")
        out[name] = dict(max_rel_err=errs, launches=n_k)
        del params, x, w, named, leaves, got, y_k, g_k, y_n, g_n, grads_k, grads_n
        settle()
    print("70B connector ([8, 500, 1024] -> 8192, 8 heads of 1024), kernels vs plain: "
          + json.dumps(out))
    return out


def _named_leaves(tree, prefix: tuple = ()) -> dict:
    """{key path: tensor} of a nested dict of parameters, in order."""
    import torch

    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    return {p: t for k, v in tree.items() for p, t in _named_leaves(v, (*prefix, k)).items()}


def llama2_13b_phase(seed: int) -> dict:
    """Phase 27: ``flagship_llama2_13b()`` at full width and depth, the
    panel kernels in its connectors (8 heads of 640), its f32 check at
    ``LLAMA2_13B_REDUCED``, and the 70B's connector alone (8 heads of
    1024); launches exact and derived from the widths."""
    t_all = time.perf_counter()
    res, by_path = llama2_runs(seed, "llama2_13b", flagship_llama2_13b, (),
                               LLAMA2_13B_REDUCED, LLAMA2_13B_QMM, 2700)
    res["connector70b"] = connector70b_rows(seed)
    res.update(launches_by_path=by_path, seconds=time.perf_counter() - t_all)
    print(f"llama2 13b phase: {res['seconds']:.1f} s")
    return res


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mesh-worker", default=None, help=argparse.SUPPRESS)
    p.add_argument("--mesh-only", action="store_true",
                   help="build the kernels and run phase 21 alone")
    p.add_argument("--tp-only", action="store_true",
                   help="build the kernels and run phase 22 alone")
    p.add_argument("--sp-only", action="store_true",
                   help="build the kernels and run phase 23 alone")
    p.add_argument("--pp-only", action="store_true",
                   help="build the kernels and run phase 24 alone")
    p.add_argument("--ep-only", action="store_true",
                   help="build the kernels and run phase 25 alone")
    p.add_argument("--llama2-only", action="store_true",
                   help="build the kernels and run phase 26 alone")
    p.add_argument("--llama2-13b-only", action="store_true",
                   help="build the kernels and run phase 27 alone")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the "
              "card", file=sys.stderr)
        return 2
    try:
        from avsr_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: avsr_tpu_torch not found next to this script ({e})",
              file=sys.stderr)
        return 2
    if args.mesh_worker:              # one rank of phase 21 or 22
        return mesh_worker(args.mesh_worker)

    print(gpu_line())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    # f32 matmuls and convolutions in full f32 (cuDNN's default is TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_run = time.perf_counter()
    laps = [t_run]

    def lap() -> None:
        """Between two phases: their seconds, then ``settle``."""
        now = time.perf_counter()
        print(f"chip_smoke: phase boundary at {now - t_run:.1f} s (+{now - laps[-1]:.1f} s)")
        laps.append(now)
        settle()

    t0 = time.perf_counter()
    _build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(_build.KERNEL_SOURCES)})")
    spills = []
    for name, log in _build.build_logs.items():
        fn = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                fn = kernel_label(line)
            elif "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas {name} {fn}: {line.strip()}")
                if "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line:
                    spills.append(f"{name} {fn}")
    check(not spills, f"kernels that spill registers: {spills}")
    try:
        if args.mesh_only:
            print(json.dumps(mesh_phase(args.seed)))
            return 0
        if args.tp_only:
            res = tp_phase(args.seed)
            res.pop("refs")
            print(json.dumps(res))
            return 0
        if args.sp_only:
            print(json.dumps(sp_phase(args.seed)))
            return 0
        if args.pp_only:
            print(json.dumps(pp_phase(args.seed)))
            if not args.ep_only:
                return 0
        if args.ep_only:
            print(json.dumps(ep_phase(args.seed)))
            return 0
        if args.llama2_only:
            print(json.dumps(llama2_phase(args.seed)))
            if not args.llama2_13b_only:
                return 0
        if args.llama2_13b_only:
            print(json.dumps(llama2_13b_phase(args.seed)))
            return 0
        return run_all(args.seed, lap)
    finally:
        close_pools()


def run_all(seed: int, lap) -> int:
    """Every phase in order; the last lines of a passing run."""
    import torch

    args = argparse.Namespace(seed=seed)

    # main-path lengths: 10 s of audio -> 500 Whisper frames; the LLM prefix
    # is 33 prompt tokens (BOS + 32 bytes) + 500 fused features
    rows = kernel_phase(args.seed, {"whisper": 500, "llm_prefill": 533})
    res = main_path_phase(args.seed)
    for r in rows:            # launches per generate_tokens call, counted there
        r["launches_per_call"] = res["flash_launches_by_shape"][r["shape"]]
    lap()
    cli_phase(args.seed)
    lap()
    # train lengths: 33 prompt tokens + 500 features + 48 label tokens = 581
    # valid of 661 packed, padded to 672
    bwd = bwd_kernel_phase(args.seed, 581)
    lap()
    train = train_phase(args.seed)
    lap()
    train_cli_phase(args.seed)
    lap()
    # Quantized serving last, so that the phases above run as they did
    # before it existed. The flagship LLM has 16 layers; 100 tokens take 99
    # decode steps.
    qmm = qmm_kernel_phase(args.seed, n_layers=16, steps=res["decode_steps"])
    lap()
    serve = {"serve_preset": preset_phase(args.seed, res, qmm)}
    lap()
    serve["serve_8bit"] = preset_phase(args.seed, res, qmm, INT8_OVERRIDES, tag="use_8bit",
                                       against_bf16_weights=False)
    lap()
    cli_phase(args.seed, PRESET_OVERRIDES, tag="preset_cli")
    lap()
    ckpt = checkpoint_phase(args.seed, res, serve["serve_preset"])
    ckpt["preprocess_frames"] = frames_phase(args.seed)
    cl = ckpt["launches"]
    check(all(cl.values()), f"a kernel did not launch on the checkpoint path: {cl}")
    lap()
    knobs = train_knobs_phase(args.seed, train)
    kl = knobs["launches"]
    check(all(kl.values()), f"a kernel did not launch on the train-knobs path: {kl}")

    lap()
    # Phase 13 at full width: beam search, speculative decoding, the
    # streaming continuation and the distillation CLI.
    variants = decode_variants_phase(args.seed, res)
    vl = variants["launches"]
    check(all(vl.values()), f"a kernel did not launch on the decode-variants path: {vl}")

    lap()
    # Phase 14 at full width: the serving engine, the multi-LoRA bank,
    # speculative slots, the HTTP server and streaming transcription.
    serving = serving_phase(args.seed, res)
    sl = serving["launches"]
    check(all(sl[k] for k in ("flash_fwd", "qmatmul_int8", "qmatmul_int4")),
          f"a kernel did not launch on the serving path: {sl}")

    lap()
    # Phase 15 at full width: a real-file corpus through the train, decode
    # and prepare_data CLIs, the compact link and the engine.
    corpus = corpus_phase(args.seed)

    lap()
    # Phase 16 at full width: HF and reference-trainer checkpoints converted,
    # and hubert_base trained, decoded, served and streamed from its export.
    conv = convert_phase(args.seed)

    lap()
    # Phase 17 at full width: every connector decoded and trained, the flash
    # kernels at head width 256, the f32 engine and the CLIs with cross_modal.
    connectors = connector_phase(args.seed)

    lap()
    # Phase 18 at full width: both MoE forms trained, decoded, quantized and
    # served; the f32 engine, speculative decoding and the decode CLI exact.
    moe = moe_phase(args.seed)

    lap()
    # Phase 19 at full width: ResNet-50, EfficientNet-b0 and AV-HuBERT-base
    # decoded, trained, served and converted; AV-HuBERT's flash path at 300
    # frames, its tuned blocks, its CLIs on the corpus; the preset with ResNet.
    video = video_encoder_phase(args.seed)

    lap()
    # Phase 20 at full width: the tooling CLIs; validate's gate on a NaN
    # leaf, each component's bytes, and profiles of the train step and of a
    # decode call (bf16 and the preset) whose kernels equal the counters.
    tooling = tooling_phase(args.seed)
    tk = {k: sum(n[k] for n in tooling["launches_by_path"].values()) for k in counts()}
    check(all(tk[k] for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")),
          f"a flash kernel did not launch on the tooling path: {tk}")

    lap()
    # Phase 21 at full width: the train step, the train CLI and the decode
    # CLI across processes (2 ranks on card 0 over gloo; 2 ranks on 2 cards
    # over NCCL where there are two), each rank's launches counted.
    mesh = mesh_phase(args.seed)
    mk = {k: sum(n[k] for n in mesh["launches_by_path"].values()) for k in counts()}
    check(all(mk.values()), f"a kernel did not launch on the mesh path: {mk}")

    lap()
    # Phase 22 at full width: tensor parallelism (mesh.tp=2) across
    # processes, the train step, the train CLI and the decodes, each rank's
    # launches counted.
    tp = tp_phase(args.seed)
    tk2 = {k: sum(n[k] for n in tp["launches_by_path"].values()) for k in counts()}
    check(all(tk2.values()), f"a kernel did not launch on the tp path: {tk2}")

    lap()
    # Phase 23 at full width and depth: sequence parallelism (mesh.sp=2)
    # across processes, the ring against the whole sequence, the train step
    # with exact launches per rank, the train CLI and the decodes.
    tp_refs = tp.pop("refs")
    sp = sp_phase(args.seed, tp_refs)
    sk = {k: sum(n[k] for n in sp["launches_by_path"].values()) for k in counts()}
    check(all(sk.values()), f"a kernel did not launch on the sp path: {sk}")

    lap()
    # Phase 24: pipeline parallelism (mesh.pp=2) across processes, the train
    # steps at full depth with exact launches per stage, the train CLI and
    # the decode CLI (f32 hypotheses against phase 22's; the preset).
    pp = pp_phase(args.seed, tp_refs)
    pk = {k: sum(n[k] for n in pp["launches_by_path"].values()) for k in counts()}
    check(all(pk.values()), f"a kernel did not launch on the pp path: {pk}")

    lap()
    # Phase 25: mixture of experts across processes and expert parallelism
    # (mesh.ep=2) on flagship_moe(), on phase 24's rank pool: the train steps
    # at full depth with exact launches per rank, an sp=2 step, the CLIs.
    ep = ep_phase(args.seed)
    ek = {k: sum(n[k] for n in ep["launches_by_path"].values()) for k in counts()}
    check(all(ek.values()), f"a kernel did not launch on the ep path: {ek}")
    close_pools()

    lap()
    # Phase 26: the flash kernels at every head width 64-512, and the
    # flagship with Llama-2-7B and the attention connector (heads of 128 in
    # the LLM, of 512 in the connectors) at full width and depth.
    llama2 = llama2_phase(args.seed)
    lk = {k: sum(n[k] for n in llama2["launches_by_path"].values()) for k in counts()}
    check(all(lk.values()), f"a kernel did not launch on the Llama-2 path: {lk}")

    lap()
    # Phase 27: the flagship with Llama-2-13B and the attention connector
    # (heads of 128 in the LLM, of 640 in the connectors: the panel kernels)
    # at full width and depth, and the 70B's connector (heads of 1024) alone.
    llama13 = llama2_13b_phase(args.seed)
    lk13 = {k: sum(n[k] for n in llama13["launches_by_path"].values()) for k in counts()}
    check(all(lk13.values()), f"a kernel did not launch on the Llama-2-13B path: {lk13}")

    def corpus_paths(name: str) -> dict[str, int]:
        return {part: n[name]
                for phase in (corpus, conv, connectors, moe, video, tooling, mesh, tp, sp, pp,
                              ep, llama2, llama13)
                for part, n in phase["launches_by_path"].items() if n[name]}

    def sp_ring(name: str) -> dict:
        """The flash kernel ``name``'s launches per rank of phase 23's train
        steps (the ring's blocks: exact, checked there), and its ring rows."""
        return {part.removeprefix("sp_"): n[name] for part, n in sp["launches_by_path"].items()
                if part.startswith("sp_gloo_train_") or part.startswith("sp_gloo_ring_")}

    def pp_stage(name: str) -> dict:
        """The flash kernel ``name``'s launches per rank (stage) of phase
        24's train steps (exact, checked there)."""
        return {part.removeprefix("pp_"): n[name] for part, n in pp["launches_by_path"].items()
                if part.startswith("pp_gloo_train_")}

    def ep_ranks(name: str) -> dict:
        """The kernel ``name``'s launches per rank of phase 25's train steps
        (exact, checked there) and of its preset decode CLI."""
        return {part.removeprefix("ep_"): n[name] for part, n in ep["launches_by_path"].items()
                if part.startswith("ep_gloo_") and "_rank" in part
                and ("_train_" in part or "decode_cli_preset" in part)}

    def serve_paths(name: str) -> dict[str, int]:
        return {f"serving_{part}": n[name]
                for part, n in serving["launches_by_path"].items() if n[name]}

    def knob_paths(name: str) -> dict[str, int]:
        return {**{f"knobs_{part}": n[name] for part, n in knobs["launches_by_path"].items()},
                **{part: n[name] for part, n in variants["launches_by_path"].items()}}

    def conn_launches(suffix: str, name: str) -> dict[str, int]:
        """One audio connector call's launches (or one forward and backward
        of it), counted alone in phase 17."""
        return {c: connectors["launches_by_path"][f"{c}_audio_connector{suffix}"][name]
                for c in ATTENTIVE}

    # the speculative drafts' M = 8 products of the bf16 runs, on the rows of
    # the qmatmul phase (the int4 head at M = 8 is a row of phase 13)
    sb = variants["spec_bf16"]
    for r in qmm["rows"]:
        if r["shape"] == "lm_head":
            r["launches_by_call"].update(spec_bf16_int8=sb["int8"]["draft_steps"],
                                         spec_bf16_layerskip8=sb["layerskip8"]["draft_steps"])
        elif r["bits"] == 8:
            r["launches_by_call"].update(
                spec_bf16_int8=16 * sb["int8"]["draft_steps"],
                spec_bf16_layerskip8=8 * sb["layerskip8"]["draft_steps"])
        else:
            r["launches_by_call"]["spec_bf16_int4"] = 16 * sb["int4"]["draft_steps"]
        r["launches_per_call"] = max(r["launches_by_call"].values())
    qmm["rows"] += variants["qmm_rows"]

    def total(key: str) -> float:
        return sum(r[key] * r["launches_per_call"] for r in rows)

    tl = train["launches"]
    kernels = [dict(
        name="flash_fwd", route="cuda", source="avsr_tpu_torch/csrc/flash_fwd.cu",
        replaces="avsr_tpu/ops/attention.py:98",
        launches=(res["flash_launches"] + tl["fwd"] + cl["flash_fwd"] + kl["flash_fwd"]
                  + vl["flash_fwd"] + sl["flash_fwd"]
                  + sum(corpus_paths("flash_fwd").values())),
        launches_by_path={"serve": res["flash_launches"], "train_3_steps": tl["fwd"],
                          "checkpoint": cl["flash_fwd"], **knob_paths("flash_fwd"),
                          **serve_paths("flash_fwd"), **corpus_paths("flash_fwd")},
        max_abs_err=max(r["max_abs_err"] for r in rows),
        max_lse_err=max(r["max_lse_err"] for r in rows),
        ms=total("ms"), kernel_ms=total("ms"), plain_ms=total("plain_ms"),
        bound_ms=total("bound_ms"),
        bound_by="operations" if total("ops_ms") >= total("bytes_ms") else "bytes",
        library_ms=total("library_ms"),
        library_is="the faster of SDPA with the boolean mask and SDPA (flash "
                   "backend) on the valid rows, per shape, from a replayed CUDA graph",
        times_are="sums over the launches of one generate_tokens call (device "
                  "time per launch from a replayed CUDA graph x launches)",
        shapes=rows, train_shape={**bwd["fwd"], "library_ms": bwd["library_fwd"]["ms"],
                                  "library": bwd["library_fwd"]},
        hubert_shape=conv["hubert_kernel"],
        connector_shape=dict(**connectors["kernels"]["fwd"], times_are="per launch",
                             launches_per_audio_connector_call=conn_launches("", "flash_fwd")),
        avhubert_shape=dict(video["kernel"], times_are="per launch",
                            launches_per_encode=video["avhubert_300"]["launches_per_encode"]),
        sp_ring=dict(launches_per_rank=sp_ring("flash_fwd"), rows=sp["ring"],
                     times_are="ms per ring forward on a rank (every block, the shifts "
                               "and the merge), CUDA events around 5 calls"),
        pp_stage=dict(launches_per_rank=pp_stage("flash_fwd"),
                      shape=pp["stage_shape"]),
        ep_ranks=dict(launches_per_rank=ep_ranks("flash_fwd")))]
    wb = knobs["whisper_bwd"]
    hbwd = kernels[0]["hubert_shape"].pop("bwd")
    abwd = kernels[0]["avhubert_shape"].pop("bwd")
    tuned = video["avhubert_finetune"]["launches_per_step"]
    for name, key, line, errs, extra in (
            ("flash_bwd_dq", "dq", 181, ("dq",),
             dict(also_writes="delta = rowsum(dO * O), [B, H, Tq] f32")),
            ("flash_bwd_dkv", "dkv", 241, ("dk", "dv"),
             dict(reads="delta in place of O",
                  noncausal_ms=bwd["dkv_noncausal_ms"]))):
        extra["whisper_shape"] = dict(
            **wb[key], shape=wb["shape"], library_ms=wb["library_bwd_pair"]["ms"],
            library=wb["library_bwd_pair"],
            max_rel_err=max(wb["max_rel_err"][e] for e in errs))
        extra["hubert_shape"] = dict(
            **hbwd[key], shape=kernels[0]["hubert_shape"]["q"], causal=False, lens=499,
            library_ms=hbwd["library_bwd_pair"]["ms"], library=hbwd["library_bwd_pair"],
            max_rel_err=max(hbwd["max_rel_err"][e] for e in errs))
        extra["avhubert_shape"] = dict(
            **abwd[key], shape=kernels[0]["avhubert_shape"]["q"], causal=False, lens=300,
            library_ms=abwd["library_bwd_pair"]["ms"], library=abwd["library_bwd_pair"],
            max_rel_err=max(abwd["max_rel_err"][e] for e in errs),
            launches_per_finetune_step=tuned[name])
        extra["connector_shape"] = dict(
            **connectors["kernels"][key],
            launches_per_audio_connector_backward=conn_launches("_grad", name),
            times_are="per launch; library_ms is SDPA's backward of q, k and v together")
        extra["sp_ring"] = dict(launches_per_rank=sp_ring(name))
        extra["pp_stage"] = dict(launches_per_rank=pp_stage(name))
        extra["ep_ranks"] = dict(launches_per_rank=ep_ranks(name))
        kernels.append(dict(
            name=name, route="cuda", source="avsr_tpu_torch/csrc/flash_bwd.cu",
            replaces=f"avsr_tpu/ops/attention.py:{line}",
            launches=tl[key] + cl[name] + kl[name] + vl[name]
            + sum(corpus_paths(name).values()),
            launches_by_path={"train_3_steps": tl[key], "checkpoint": cl[name],
                              **knob_paths(name), **corpus_paths(name)},
            max_abs_err=max(bwd["max_abs_err"][e] for e in errs),
            max_rel_err=max(bwd["max_rel_err"][e] for e in errs),
            ms=bwd[key]["ms"], plain_ms=bwd[key]["plain_ms"],
            bound_ms=bwd[key]["bound_ms"], bound_by=bwd[key]["bound_by"],
            library_ms=bwd["library_bwd_pair"]["ms"],
            library_is=f"SDPA backward of q, k and v together (dq + dk/dv), "
                       f"the faster call: {bwd['library_bwd_pair']['call']}, from "
                       f"a replayed CUDA graph",
            library=bwd["library_bwd_pair"],
            times_are="per launch at the train shape, from a replayed CUDA graph",
            shape=bwd["shape"], **extra))
    for name, bits, line in (("qmatmul_int8", 8, 120), ("qmatmul_int4", 4, 140)):
        qrows = [r for r in qmm["rows"] if r["bits"] == bits]

        def qtotal(key: str) -> float:
            return sum(r[key] * n for r in qrows for n in r["launches_by_call"].values())

        by_path = {path: out["launches"][name] for path, out in serve.items()}
        by_path["checkpoint"] = cl[name]
        by_path.update(knob_paths(name))
        by_path.update(serve_paths(name))
        by_path.update(corpus_paths(name))
        trows = [r for r in tp["qmm_parity"] if r["bits"] == bits]
        kernels.append(dict(
            name=name, route="cuda", source="avsr_tpu_torch/csrc/qmatmul.cu",
            replaces=f"avsr_tpu/ops/qmatmul.py:{line}",
            launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=max(r["max_abs_err"] for r in qrows + trows),
            max_rel_err=max(r["max_rel_err"] for r in qrows + trows),
            tp_shapes=trows, ep_ranks=dict(launches_per_rank=ep_ranks(name)),
            edge_max_rel_err=qmm["edge_max_rel_err"],
            ms=qtotal("ms"), plain_ms=qtotal("plain_ms"), bound_ms=qtotal("bound_ms"),
            bound_by="operations" if qtotal("ops_ms") >= qtotal("bytes_ms") else "bytes",
            library_ms=qtotal("library_ms"),
            library_is="torch.matmul of the bf16 x with the weight dequantized to "
                       "bf16 beforehand (cuBLAS), per shape",
            dequant_matmul_ms=qtotal("dequant_matmul_ms"),
            times_are="sums over the launches of one call of each path that runs "
                      "the kernel (generate_tokens with the preset and with use_8bit, "
                      "the preset's beam search, the bf16 speculative calls; device "
                      "time per launch from a replayed CUDA graph x launches)",
            shapes=qrows))
    # phases 26 and 27: every head width held to the plain versions, the
    # 7B's, the 13B's and the connectors' shapes timed (per launch), the
    # decode products of both
    lw = llama2["kernels"]
    for kern in kernels:
        key = {"flash_fwd": "fwd", "flash_bwd_dq": "dq", "flash_bwd_dkv": "dkv"}.get(kern["name"])
        if key is None:
            bits = 8 if kern["name"] == "qmatmul_int8" else 4
            kern["llama2_shapes"] = [r for r in llama2["qmm_rows"] if r["bits"] == bits]
            kern["llama2_13b_shapes"] = [r for r in llama13["qmm_rows"] if r["bits"] == bits]
            continue
        l7, l13 = llama2["launches_by_path"], llama13["launches_by_path"]
        kern["llama2"] = dict(
            launches_per_call=l7["llama2_generate"][kern["name"]],
            launches_per_train_step=l7["llama2_train_2_steps"][kern["name"]] // 2,
            max_rel_err_by_width={D: w["max_rel_err"] for D, w in lw["widths"].items()},
            kernel_width_by_width={D: w["kernel_width"] for D, w in lw["widths"].items()},
            shapes={n: dict(r[key], q=r["q"], kv=r["kv"], causal=r["causal"], lens=r["lens"],
                            kernel_width=r["kernel_width"], max_rel_err=r["max_rel_err"],
                            **{k: r[k] for k in ("fwd_pad_ms", "bwd_pad_ms", "cluster",
                                                 "f32_max_rel_err") if k in r})
                    for n, r in lw["shapes"].items() if key == "fwd" or "prefill" not in n},
            **({"pad_route": lw["pad_route"]} if key == "fwd" else {}),
            times_are="per launch, from a replayed CUDA graph; library_ms is SDPA "
                      "(the backward's: q, k and v together), library_backend the "
                      "backend SDPA took")
        kern["llama2_13b"] = dict(
            launches_per_call=l13["llama2_13b_generate"][kern["name"]],
            launches_per_train_step=l13["llama2_13b_train_2_steps"][kern["name"]] // 2,
            launches_per_f32_call=l13["llama2_13b_f32"][kern["name"]],
            connector70b=llama13["connector70b"])
    lap()
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
