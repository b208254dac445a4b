"""The port's continuous-batching engine and multi-LoRA bank vs the JAX
package (f32, CPU), the counterparts of ``tests/test_engine.py``'s cases
(tensor parallelism is not ported; the MoE case is in
``test_torch_moe_llm.py``).

The engine's contract: every request's transcript equals a standalone
``generate_tokens`` call for it, token for token. Each case holds the
port's engine to the port's ``generate_tokens`` and to JAX's (or to JAX's
``ServingEngine``), with the same weights: the JAX init of tiny_cpu.yaml
with a 2-layer LLM, an untied head and LoRA ``b`` randomised, moved across
by ``convert.from_numpy_tree``. EOS is byte 10, which this model emits at
different steps per request, so slots free up raggedly. Where stats are
compared, both engines' prep workers (and JAX's fetcher) are swapped for
synchronous ones, so the schedule depends on nothing but the requests.
Tolerance: exact equality of tokens and of the schedule's counters.
"""

import importlib
from collections import deque
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsr_tpu.core.config import load_config as jload_config
from avsr_tpu.data import dataset as jdataset
from avsr_tpu.data import loader as jloader
from avsr_tpu.infer import adapters as jad
from avsr_tpu.infer import engine as jengine
from avsr_tpu.models import avsr as javsr
from avsr_tpu.ops import quant as jquant
from avsr_tpu_torch.convert import from_numpy_tree
from avsr_tpu_torch.core import config as tcfg
from avsr_tpu_torch.data import dataset as tdataset
from avsr_tpu_torch.data import loader as tloader
from avsr_tpu_torch.data.dataset import Sample
from avsr_tpu_torch.data.tokenizer import ByteTokenizer
from avsr_tpu_torch.infer import adapters as tad
from avsr_tpu_torch.infer import engine as tengine
from avsr_tpu_torch.infer import generate as tgen
from avsr_tpu_torch.infer import speculative as tspec
from avsr_tpu_torch.ops import quant as tquant

from test_torch_models import np_tree, randomize_lora_b

torch.set_num_threads(1)

jgen = importlib.import_module("avsr_tpu.infer.generate")

REPO = Path(__file__).resolve().parent.parent
TINY_YAML = REPO / "avsr_tpu" / "configs" / "tiny_cpu.yaml"
OVERRIDES = {"model.llm.n_layers": 2, "model.llm.tie_embeddings": False}
EOS = 10


class Tok(ByteTokenizer):
    """The byte tokenizer with an EOS this model emits mid-stream."""

    def __init__(self) -> None:
        super().__init__()
        self.eos_id = EOS


def configs(**extra):
    over = {**OVERRIDES, **extra}
    return (jload_config(TINY_YAML, over),
            tcfg.load_config(TINY_YAML, [f"{k}={v}" for k, v in over.items()]))


def model(jc, seed: int = 0):
    """(JAX params, port params) of one init, LoRA b randomised."""
    params = np_tree(javsr.init_avsr_model(jax.random.key(seed), jc.model))
    randomize_lora_b(params, seed=2, scale=0.5)
    return jax.tree_util.tree_map(jnp.asarray, params), from_numpy_tree(params, "cpu")


@pytest.fixture(scope="module")
def tiny():
    jc, tc = configs()
    p_j, p_t = model(jc)
    return dict(jc=jc, tc=tc, p_j=p_j, p_t=p_t, tok=Tok())


def samples(lengths, seed: int = 0, frames: bool = False):
    """Port samples and JAX samples of the same random audio (and frames)."""
    rng = np.random.default_rng(seed)
    media = [((0.3 * rng.standard_normal(n)).astype(np.float32),
              rng.integers(0, 256, (4, 16, 16, 3)).astype(np.uint8) if frames else None)
             for n in lengths]
    return ([Sample(f"u{i}", a, f, "", [EOS]) for i, (a, f) in enumerate(media)],
            [jdataset.Sample(f"u{i}", a, f, "", [EOS]) for i, (a, f) in enumerate(media)])


def ref_t(params, cfg, tok, sample, max_new, **kw):
    """The port's standalone single-request decode."""
    hb = tloader.collate([sample], cfg.data, tok.encode(cfg.model.prompt, add_bos=True),
                         tok.pad_id)
    out = tgen.generate_tokens(params, cfg.model, tloader.featurize(hb, "cpu", torch.float32),
                               max_new_tokens=max_new, eos_id=tok.eos_id, **kw)
    return out.tokens[0, : int(out.lengths[0])].tolist()


def ref_j(params, cfg, tok, sample, max_new, **kw):
    """JAX's standalone single-request decode."""
    hb = jloader.collate([sample], cfg.data, tok.encode(cfg.model.prompt, add_bos=True),
                         tok.pad_id)
    batch = jloader.featurize(hb, cfg.runtime.compute_dtype,
                              jloader.audio_frontend_for(cfg.model),
                              jloader.image_stats_for(cfg.model))
    out = jgen.generate_tokens(params, cfg.model, batch, max_new_tokens=max_new,
                               eos_id=tok.eos_id, compute_dtype=cfg.runtime.compute_dtype,
                               use_pallas="never", **kw)
    return [int(t) for t in np.asarray(out.tokens)[0, : int(out.lengths[0])]]


class SyncPrep:
    """A prep worker that prepares each group when it is submitted."""

    def __init__(self, fn):
        self._fn, self._out = fn, deque()

    def submit(self, group):
        self._out.append((group, self._fn([s for _, s, *_ in group])))

    def ready(self, block=False):
        return self._out.popleft() if self._out else None

    def close(self):
        pass


class SyncFetcher:
    """JAX's fetcher, fetching each chunk when it is submitted."""

    def __init__(self):
        self._out = deque()

    def submit(self, c):
        self._out.append((c, jax.device_get((c.out, c.steps, [t for _, t in c.admits]))))

    def done(self, block=False):
        return self._out.popleft() if self._out else None

    def close(self):
        pass


@pytest.fixture
def sync(monkeypatch):
    monkeypatch.setattr(jengine, "_PrepWorker", SyncPrep)
    monkeypatch.setattr(jengine, "_Fetcher", SyncFetcher)
    monkeypatch.setattr(tengine, "_PrepWorker", SyncPrep)


LENGTHS = [4800, 16000, 8000, 12000, 6400, 9600, 20000]   # both length buckets


@pytest.mark.parametrize("admission,slots,k", [("budget", 2, 3), ("fifo", 3, 2)])
def test_engine_token_exact_with_refill(tiny, sync, admission, slots, k):
    """More requests than slots, ragged lengths and EOS steps: every
    transcript equals the standalone decode of both packages and JAX's
    engine, and the schedule (chunks, steps, stages, installs,
    utilization) is JAX's."""
    r = tiny
    ts, js = samples(LENGTHS)
    kw = dict(num_slots=slots, max_new_tokens=8, k_steps=k, admission=admission)
    eng = tengine.ServingEngine(r["p_t"], r["tc"], r["tok"], **kw)
    got = eng.transcribe(ts)
    jeng = jengine.ServingEngine(r["p_j"], r["jc"], r["tok"], **kw)
    assert got == jeng.transcribe(js)
    assert eng.stats() == jeng.stats()
    for i, s in enumerate(ts):
        assert got[i] == ref_t(r["p_t"], r["tc"], r["tok"], s, 8), i
    lens = {len(g) for g in got}
    assert len(lens) > 1 and min(lens) < 8          # EOS ended some early


def test_port_reference_decode_equals_jax(tiny):
    r = tiny
    ts, js = samples(LENGTHS)
    for t, j in zip(ts, js):
        assert ref_t(r["p_t"], r["tc"], r["tok"], t, 8) == ref_j(r["p_j"], r["jc"], r["tok"],
                                                                 j, 8)


def test_engine_single_slot_serializes(tiny):
    """num_slots=1: sequential decoding, the slot reused by every request
    (readmission overwrites the stale row completely)."""
    r = tiny
    ts, _ = samples([8000, 12000, 6400], seed=1)
    eng = tengine.ServingEngine(r["p_t"], r["tc"], r["tok"], num_slots=1, max_new_tokens=6,
                                k_steps=4)
    got = eng.transcribe(ts)
    for i, s in enumerate(ts):
        assert got[i] == ref_t(r["p_t"], r["tc"], r["tok"], s, 6)


def test_engine_int8_kv_matches_static_int8(tiny, sync):
    """decode.kv_cache_dtype=int8: staged rows quantize with per-slot
    scales, the static int8 path's math, so transcripts equal the
    standalone int8 decode and JAX's int8 engine."""
    r = tiny
    jc, tc = configs(**{"decode.kv_cache_dtype": "int8"})
    ts, js = samples([8000, 12000, 6400, 16000], seed=2)
    kw = dict(num_slots=2, max_new_tokens=6, k_steps=3)
    eng = tengine.ServingEngine(r["p_t"], tc, r["tok"], **kw)
    got = eng.transcribe(ts)
    assert eng.cache.k.dtype == torch.int8
    jeng = jengine.ServingEngine(r["p_j"], jc, r["tok"], **kw)
    assert got == jeng.transcribe(js)
    assert eng.stats() == jeng.stats()
    for i, s in enumerate(ts):
        assert got[i] == ref_t(r["p_t"], tc, r["tok"], s, 6, kv_cache_dtype="int8"), i


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slot_sample_apply_equals_jax_given_its_noise(seed):
    """``_slot_sample``'s apply against JAX's ``_slot_sample`` fed the same
    Gumbel noise (JAX's categorical is argmax(logits + gumbel(key))):
    greedy rows, several temperatures and nucleus sizes."""
    S, V = 6, 40
    rng = np.random.default_rng(seed)
    logits = (3.0 * rng.standard_normal((S, V))).astype(np.float32)
    temps = np.array([0.0, 0.5, 1.0, 2.0, 0.0, 5.0], np.float32)
    tops = np.array([1.0, 0.9, 0.5, 1.0, 0.3, 0.95], np.float32)
    key = jax.random.key(seed)
    want = jengine._slot_sample(jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(tops),
                                key)
    noise = np.asarray(jax.random.gumbel(key, (S, V), jnp.float32))
    got = tengine._slot_sample(torch.from_numpy(logits), torch.from_numpy(temps),
                               torch.from_numpy(tops), torch.from_numpy(noise.copy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_engine_sampling_is_seeded_and_stays_in_the_nucleus(tiny):
    """Mixed workload: greedy rows in a sampling chunk equal the greedy
    decode; sampled rows repeat under one engine seed, change under
    another, and every sampled token lies in its step's top-p set (checked
    against the teacher-forced logits of the emitted stream)."""
    r = tiny
    tc, tok = r["tc"], r["tok"]
    ts, _ = samples([8000, 8000, 12000, 6400], seed=3)
    temps, tops = [0.0, 2.0, 0.0, 1.5], [1.0, 0.6, 1.0, 0.8]

    def run(seed):
        eng = tengine.ServingEngine(r["p_t"], tc, tok, num_slots=2, max_new_tokens=8,
                                    k_steps=3, seed=seed)
        return eng.transcribe(ts, temperature_per_request=temps, top_p_per_request=tops)

    got = run(0)
    for i in (0, 2):
        assert got[i] == ref_t(r["p_t"], tc, tok, ts[i], 8)
    assert run(0) == got
    assert any(run(s)[1] != got[1] for s in range(1, 4))
    from avsr_tpu_torch.models import avsr as tavsr
    from avsr_tpu_torch.models import llama as tllama
    for i in (1, 3):
        hb = tloader.collate([ts[i]], tc.data, tok.encode(tc.model.prompt, add_bos=True),
                             tok.pad_id)
        batch = tloader.featurize(hb, "cpu", torch.float32)
        enc = tavsr.encode(r["p_t"], tc.model, batch)
        prefix, plens = tavsr.build_prefix(r["p_t"], tc.model, batch, enc)
        P = int(plens[0])
        ids = torch.tensor(got[i])
        x = torch.cat([prefix[:, :P], tllama.embed_tokens(r["p_t"]["llm"], ids[None])], 1)
        logits, _ = tllama.llama_apply(r["p_t"]["llm"], tc.model.llm, inputs_embeds=x,
                                       lora=tc.model.lora)
        step_logits = logits[0, P - 1: P - 1 + len(got[i])] / temps[i]
        kept = tgen._top_p_filter(step_logits, tops[i]) > -1e29
        assert bool(kept[torch.arange(len(got[i])), ids].all()), i


def test_engine_online_submit_step(tiny):
    """Requests submitted mid-decode still equal the standalone decode;
    step() returns finishes incrementally and collect() pops."""
    r = tiny
    ts, _ = samples([8000, 12000, 6400, 16000, 8000], seed=4)
    eng = tengine.ServingEngine(r["p_t"], r["tc"], r["tok"], num_slots=2, max_new_tokens=7,
                                k_steps=2)
    ids = [eng.submit(s) for s in ts[:2]]
    eng.step()                                   # first chunk in flight
    ids += [eng.submit(s) for s in ts[2:]]       # arrive mid-decode
    finished = {}
    while eng.outstanding():
        finished.update(eng.step())
    assert set(finished) == set(ids)
    for i, s in zip(ids, ts):
        assert finished[i] == ref_t(r["p_t"], r["tc"], r["tok"], s, 7)
        assert eng.collect(i) == finished[i]
        assert eng.collect(i) is None            # popped


def test_engine_stats_equal_jax_after_warmup(tiny, sync):
    """Warmup work is excluded from stats(); the counters of a served
    workload equal JAX's engine's."""
    r = tiny
    ts, js = samples([8000] * 5, seed=5)
    kw = dict(num_slots=2, max_new_tokens=6, k_steps=3)
    eng = tengine.ServingEngine(r["p_t"], r["tc"], r["tok"], **kw)
    eng.warmup(ts[0])
    assert eng.stats()["chunks_run"] == 0
    got = eng.transcribe(ts)
    jeng = jengine.ServingEngine(r["p_j"], r["jc"], r["tok"], **kw)
    jeng.warmup(js[0])
    assert got == jeng.transcribe(js)
    st = eng.stats()
    assert st == jeng.stats()
    assert st["requests_done"] == 5
    assert st["tokens_emitted"] == sum(len(g) for g in got)
    assert 0.0 < st["chunk_utilization"] <= 1.0


def test_engine_av_modality():
    """Audio + video requests (slots are modality-agnostic rows)."""
    jc, tc = configs(**{"model.modality": "both"})
    _, p_t = model(jc)
    tok = Tok()
    ts, js = samples([8000, 12000, 6400], seed=6, frames=True)
    eng = tengine.ServingEngine(p_t, tc, tok, num_slots=2, max_new_tokens=5, k_steps=2)
    got = eng.transcribe(ts)
    for i, s in enumerate(ts):
        assert got[i] == ref_t(p_t, tc, tok, s, 5)


@pytest.mark.parametrize("modality", ["audio", "both"])
def test_engine_compact_transfer_token_exact(sync, modality):
    """data.compact_transfer (int16 PCM, planar YUV420 frames) through the
    engine's staging path: token-exact against the standalone decode of the
    same compact batches, and equal to JAX's engine (the counterpart of
    tests/test_engine.py::test_engine_compact_transfer_token_exact)."""
    jc, tc = configs(**{"data.compact_transfer": True, "model.modality": modality})
    p_j, p_t = model(jc)
    tok = Tok()
    ts, js = samples([4800, 16000, 8000], seed=7, frames=modality == "both")
    hb = tloader.collate(ts, tc.data, [1, 2], tok.pad_id)
    assert hb.audio.dtype == np.int16 and (hb.frames_y is not None) == (modality == "both")
    kw = dict(num_slots=2, max_new_tokens=6, k_steps=3)
    got = tengine.ServingEngine(p_t, tc, tok, **kw).transcribe(ts)
    assert got == jengine.ServingEngine(p_j, jc, tok, **kw).transcribe(js)
    for i, s in enumerate(ts):
        assert got[i] == ref_t(p_t, tc, tok, s, 6), i


def test_engine_admits_deferred_manifest_samples(tiny, sync, tmp_path):
    """Samples straight from a manifest dataset whose WAV decode is deferred
    (``audio_path``, no audio): the engine decodes them on admission and
    gives the tokens of the decoded samples, and JAX's engine's."""
    from avsr_tpu_torch.data.audio_io import write_wav
    from avsr_tpu_torch.data.manifest import ManifestEntry, write_manifest

    rng = np.random.default_rng(8)
    entries = []
    for i, n in enumerate([4800, 16000, 8000, 12000]):
        write_wav(tmp_path / f"u{i}.wav", (0.3 * rng.standard_normal(n)).astype(np.float32))
        entries.append(ManifestEntry(f"u{i}", "none", f"u{i}.wav", 0, n))
    write_manifest(tmp_path / "test.tsv", tmp_path, entries)
    (tmp_path / "test.wrd").write_text("a\nb\nc\nd\n")
    r = tiny
    ds_t = tdataset.ManifestAVSRDataset(
        tcfg.DataConfig(**{**vars(r["tc"].data), "path": str(tmp_path)}), r["tok"],
        split="test", modality="audio", defer_audio=True)
    ds_j = jdataset.ManifestAVSRDataset(
        type(r["jc"].data)(**{**vars(r["jc"].data), "path": str(tmp_path)}), r["tok"],
        split="test", modality="audio", defer_audio=True)
    deferred = [ds_t[i] for i in range(len(ds_t))]
    assert all(s.audio is None and s.audio_path for s in deferred)
    kw = dict(num_slots=2, max_new_tokens=6, k_steps=3)
    got = tengine.ServingEngine(r["p_t"], r["tc"], r["tok"], **kw).transcribe(deferred)
    decoded = [tdataset.Sample(s.utt_id, tdataset.load_audio(s.audio_path), None, s.text,
                               s.tokens) for s in deferred]
    assert got == tengine.ServingEngine(r["p_t"], r["tc"], r["tok"], **kw).transcribe(decoded)
    assert got == jengine.ServingEngine(r["p_j"], r["jc"], r["tok"], **kw).transcribe(
        [ds_j[i] for i in range(len(ds_j))])
    for i, s in enumerate(decoded):
        assert got[i] == ref_t(r["p_t"], r["tc"], r["tok"], s, 6), i


def test_engine_reset_recovers(tiny):
    """reset() abandons mid-flight work (ids never finish), returns every
    slot to idle, and the pool then serves fresh requests exactly (stale
    cache columns do not leak)."""
    r = tiny
    ts, _ = samples([4800, 8000, 6400], seed=7)
    eng = tengine.ServingEngine(r["p_t"], r["tc"], r["tok"], num_slots=2, max_new_tokens=6,
                                k_steps=2)
    ids = [eng.submit(s) for s in ts]
    eng.step()
    assert eng.outstanding() > 0
    eng.reset()
    assert eng.outstanding() == 0
    assert eng.done.all() and bool(eng.d_done.all())
    assert all(eng.collect(i) is None for i in ids)
    got = eng.transcribe(ts)
    for i, s in enumerate(ts):
        assert got[i] == ref_t(r["p_t"], r["tc"], r["tok"], s, 6), i


def test_engine_cancel_reclaims_capacity(tiny):
    """cancel() across the request lifecycle: resident (row masked from
    the next chunk), staged (swept at its install), unknown and finished
    (False). Cancelled ids never finish; the survivors stay exact."""
    r = tiny
    ts, _ = samples([4800, 8000, 6400, 12000], seed=8)
    eng = tengine.ServingEngine(r["p_t"], r["tc"], r["tok"], num_slots=2, max_new_tokens=6,
                                k_steps=2)
    ids = [eng.submit(s) for s in ts]
    eng.step()                        # 0/1 resident; 2/3 staged ahead
    assert eng.cancel(ids[0])         # resident
    assert eng.cancel(ids[3])         # staged
    assert not eng.cancel(9999)       # unknown
    finished = {}
    while eng.outstanding():
        finished.update(eng.step())
    assert ids[0] not in finished and ids[3] not in finished
    for rid, s in ((ids[1], ts[1]), (ids[2], ts[2])):
        assert finished[rid] == ref_t(r["p_t"], r["tc"], r["tok"], s, 6)
    assert not eng.cancel(ids[1])
    assert eng.stats()["requests_cancelled"] == 2


def np_adapter(skel_np, seed: int, std: float = 0.5):
    """A random adapter of the skeleton's shapes (numpy, the same for both
    packages)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (std * rng.standard_normal(x.shape)).astype(np.float32), skel_np)


def both_trees(tree_np):
    return jax.tree_util.tree_map(jnp.asarray, tree_np), from_numpy_tree(tree_np, "cpu")


@pytest.mark.parametrize("bits", [0, 4])
def test_engine_multi_adapter_token_exact(tiny, sync, bits):
    """Multi-tenant LoRA: a 2-adapter bank over a float base and over an
    int4 base (qdot plus the per-row adapters), tenants interleaved in one
    pool: each request equals the standalone decode with ITS adapter
    grafted on, and JAX's engine with the same bank."""
    r = tiny
    p_j, p_t = r["p_j"], r["p_t"]
    if bits:
        p_j = {**p_j, "llm": jquant.quantize_llm(p_j["llm"], bits)}
        p_t = {**p_t, "llm": tquant.quantize_llm(p_t["llm"], bits)}
    skel = np_tree(jad.extract_lora(p_j["llm"]))
    ads = [np_adapter(skel, 11 + bits), np_adapter(skel, 22 + bits)]
    pairs = [both_trees(a) for a in ads]
    bank_j = jad.stack_lora_bank([j for j, _ in pairs])
    bank_t = tad.stack_lora_bank([t for _, t in pairs])
    ts, js = samples([4800, 8000, 6400, 12000, 4800], seed=9)
    aids = [0, 1, 1, 0, 1]
    kw = dict(num_slots=2, max_new_tokens=6, k_steps=2)
    eng = tengine.ServingEngine(p_t, r["tc"], r["tok"], adapter_bank=bank_t, **kw)
    got = eng.transcribe(ts, adapter_per_request=aids)
    jeng = jengine.ServingEngine(p_j, r["jc"], r["tok"], adapter_bank=bank_j, **kw)
    assert got == jeng.transcribe(js, adapter_per_request=aids)
    refs = [{**p_t, "llm": tad.inject_lora(p_t["llm"], t)} for _, t in pairs]
    for i, (s, aid) in enumerate(zip(ts, aids)):
        assert got[i] == ref_t(refs[aid], r["tc"], r["tok"], s, 6), (i, aid)
    # teeth: the two tenants decode differently here
    assert ref_t(refs[0], r["tc"], r["tok"], ts[0], 6) != ref_t(refs[1], r["tc"], r["tok"],
                                                                ts[0], 6)
    with pytest.raises(ValueError, match="out of range"):
        eng.submit(ts[0], adapter=2)
    # a budget past the slot cache's columns is refused at submit (a write
    # past them would fault on the card; 33 + 100 + 123 fits M = 256)
    assert eng.M == 256
    eng.cancel(eng.submit(ts[0], max_new=123))
    with pytest.raises(ValueError, match="does not fit a slot"):
        eng.submit(ts[0], max_new=124)


def test_adapter_helpers_equal_jax(tiny):
    r = tiny
    sk_j, sk_t = jad.extract_lora(r["p_j"]["llm"]), tad.extract_lora(r["p_t"]["llm"])
    np.testing.assert_equal(np_tree(sk_j), tad.tree_map(lambda x: x.numpy(), sk_t))
    bank = tad.stack_lora_bank([sk_t, tad.random_adapter_like(sk_t, torch.Generator().manual_seed(0))])
    assert tad.bank_size(bank) == 2
    sel = tad.select_lora(bank, torch.tensor([1, 0, 1]))
    assert all(x.shape[0] == 3 for x in tad.leaves(sel))
    with pytest.raises(ValueError, match="layer count"):
        tad.inject_lora({**r["p_t"]["llm"], "layers": r["p_t"]["llm"]["layers"][:1]}, sk_t)
    with pytest.raises(ValueError, match="no lora leaves"):
        tad.extract_lora({"layers": [{"q": {"w": torch.zeros(2, 2)}}]})


def test_load_multilora_from_export(tmp_path):
    """CLI bank loading: base + adapter exports -> (raw base, stacked
    bank) that builds a multi-tenant engine."""
    from avsr_tpu_torch.cli.common import init_params, load_multilora
    from avsr_tpu_torch.train.checkpoint import export_params

    tc = tcfg.load_config(TINY_YAML)
    export_params(init_params(tc, seed=0, device="cpu"), tmp_path / "base")
    base, bank = load_multilora(tc, str(tmp_path / "base"), [str(tmp_path / "base")] * 2,
                                seed=1, device="cpu")
    assert tad.bank_size(bank) == 2
    eng = tengine.ServingEngine(base, tc, Tok(), num_slots=2, adapter_bank=bank)
    assert eng._n_adapters == 2
    assert load_multilora(tc, None, [], seed=0, device="cpu")[1] is None
    with pytest.raises(ValueError, match="use_lora"):
        load_multilora(tcfg.load_config(TINY_YAML, ["model.lora.use_lora=false"]), None, [],
                       seed=0, device="cpu")


def test_engine_add_adapter_hot_onboard(tiny):
    """Runtime onboarding on a bank-less engine: the first add_adapter
    creates the bank with row 0 = the base's own adapter, tenants land at
    1 and 2 (a capacity doubling), one of them while requests are in
    flight; each decodes as the standalone decode with its adapter."""
    r = tiny
    p_t = r["p_t"]
    skel = np_tree(jad.extract_lora(r["p_j"]["llm"]))
    a1 = from_numpy_tree(np_adapter(skel, 31), "cpu")
    a2 = from_numpy_tree(np_adapter(skel, 32), "cpu")
    ts, _ = samples([4800, 8000, 6400, 12000], seed=10)
    eng = tengine.ServingEngine(p_t, r["tc"], r["tok"], num_slots=2, max_new_tokens=5,
                                k_steps=2)
    assert eng.add_adapter(a1) == 1
    first = [eng.submit(ts[0], adapter=0), eng.submit(ts[1], adapter=1)]
    eng.step()
    assert eng.add_adapter(a2) == 2            # mid-flight; capacity 2 -> 4
    late = [eng.submit(ts[2], adapter=2), eng.submit(ts[3], adapter=1)]
    done = {}
    while eng.outstanding():
        done.update(eng.step())
    refs = {0: p_t, 1: {**p_t, "llm": tad.inject_lora(p_t["llm"], a1)},
            2: {**p_t, "llm": tad.inject_lora(p_t["llm"], a2)}}
    for rid, s, aid in zip(first + late, ts, (0, 1, 2, 1)):
        assert done[rid] == ref_t(refs[aid], r["tc"], r["tok"], s, 5), (rid, aid)
    with pytest.raises(ValueError, match="LoRA wiring"):
        eng.add_adapter({"layers": [None]})


def test_adapter_serving_needs_the_raw_lora_base(tiny):
    r = tiny
    fused = tgen.prepare_params_for_decode(r["p_t"], r["tc"].model)
    with pytest.raises(ValueError, match="raw params layout"):
        tengine.ServingEngine(fused, r["tc"], r["tok"], num_slots=2).add_adapter(
            tad.extract_lora(r["p_t"]["llm"]))
    _, nolora = configs(**{"model.lora.use_lora": False})
    with pytest.raises(ValueError, match="use_lora=true"):
        tengine.ServingEngine(r["p_t"], nolora, r["tok"], num_slots=2,
                              adapter_bank=tad.stack_lora_bank(
                                  [tad.extract_lora(r["p_t"]["llm"])]))


# ---------------------------------------------------------------------------
# Speculative slots
# ---------------------------------------------------------------------------

def test_engine_spec_self_draft_equals_greedy_and_jax(tiny, sync):
    """Speculative slots with the int8 self-draft: every transcript equals
    the standalone greedy decode and JAX's speculative engine, across
    mixed buckets, EOS and refills."""
    r = tiny
    ts, js = samples(LENGTHS[:5], seed=11)
    kw = dict(num_slots=2, max_new_tokens=8, k_steps=3, spec_gamma=3, spec_rounds=2)
    eng = tengine.ServingEngine(
        r["p_t"], r["tc"], r["tok"],
        draft_params=tspec.make_draft_params(r["p_t"], r["tc"].model, bits=8), **kw)
    got = eng.transcribe(ts)
    from avsr_tpu.infer import speculative as jspec
    jeng = jengine.ServingEngine(
        r["p_j"], r["jc"], r["tok"],
        draft_params=jspec.make_draft_params(r["p_j"], r["jc"].model, bits=8), **kw)
    assert got == jeng.transcribe(js)
    assert eng.stats() == jeng.stats()
    for i, s in enumerate(ts):
        assert got[i] == ref_t(r["p_t"], r["tc"], r["tok"], s, 8), i


def test_engine_spec_layerskip_draft_equals_greedy(tiny):
    """A 1-layer layer-skip draft (its own, shallower draft cache):
    acceptance is low, the worst case for the catch-up logic."""
    r = tiny
    d_raw, dcfg = tspec.make_layerskip_draft(r["p_t"], r["tc"].model, 1)
    eng = tengine.ServingEngine(
        r["p_t"], r["tc"], r["tok"], num_slots=2, max_new_tokens=7, k_steps=3,
        draft_params=tspec.make_draft_params(d_raw, dcfg, bits=8), draft_model_cfg=dcfg,
        spec_gamma=2, spec_rounds=2)
    assert eng.d_cache.k.shape[0] == 1
    ts, _ = samples([4800, 16000, 8000, 6400], seed=12)
    got = eng.transcribe(ts)
    for i, s in enumerate(ts):
        assert got[i] == ref_t(r["p_t"], r["tc"], r["tok"], s, 7), i


def test_engine_spec_identical_draft_online(tiny):
    """The target itself as draft (full accepts, the gap-2 catch-up every
    round), through submit/step with a mid-flight second wave."""
    r = tiny
    draft = tgen.prepare_params_for_decode(r["p_t"], r["tc"].model)
    eng = tengine.ServingEngine(r["p_t"], r["tc"], r["tok"], num_slots=2, max_new_tokens=10,
                                k_steps=3, draft_params=draft, spec_gamma=2, spec_rounds=3)
    ts, _ = samples([8000, 16000, 4800], seed=13)
    first = [eng.submit(s) for s in ts[:2]]
    eng.step()
    late = eng.submit(ts[2])
    done = {}
    for _ in range(60):
        done.update(eng.step())
        if len(done) == 3:
            break
    for rid, s in zip(first + [late], ts):
        assert done[rid] == ref_t(r["p_t"], r["tc"], r["tok"], s, 10), rid


def test_engine_checks_equal_jax(tiny):
    """The constructor's and submit's refusals, message for message."""
    r = tiny
    jdraft = __import__("avsr_tpu.infer.speculative", fromlist=["x"]).make_draft_params(
        r["p_j"], r["jc"].model, bits=8)
    tdraft = tspec.make_draft_params(r["p_t"], r["tc"].model, bits=8)
    ji8, ti8 = configs(**{"decode.kv_cache_dtype": "int8"})
    deep_j = {**r["p_j"], "llm": {**r["p_j"]["llm"],
                                  "layers": list(r["p_j"]["llm"]["layers"]) * 2}}
    deep_t = {**r["p_t"], "llm": {**r["p_t"]["llm"],
                                  "layers": list(r["p_t"]["llm"]["layers"]) * 2}}
    cases = [
        (dict(spec_gamma=2), dict(spec_gamma=2), None),
        (dict(draft_params=jdraft, spec_gamma=2), dict(draft_params=tdraft, spec_gamma=2),
         (ji8, ti8)),
        (dict(draft_params=deep_j, spec_gamma=2), dict(draft_params=deep_t, spec_gamma=2),
         None),
        (dict(admission="lifo"), dict(admission="lifo"), None),
    ]
    for kj, kt, cfgs in cases:
        jc, tc = cfgs or (r["jc"], r["tc"])
        with pytest.raises(ValueError) as ej:
            jengine.ServingEngine(r["p_j"], jc, r["tok"], num_slots=2, **kj)
        with pytest.raises(ValueError) as et:
            tengine.ServingEngine(r["p_t"], tc, r["tok"], num_slots=2, **kt)
        assert str(et.value) == str(ej.value)
    eng = tengine.ServingEngine(r["p_t"], r["tc"], r["tok"], num_slots=2,
                                draft_params=tdraft, spec_gamma=2)
    with pytest.raises(ValueError, match="greedy-only"):
        eng.submit(samples([4800])[0][0], temperature=0.7)


@pytest.mark.parametrize("over", [
    {"decode.engine_slots": 2, "decode.num_beams": 5},
    {"decode.stream_block_s": 0.5, "decode.stream_video_fps": 0},
    {"decode.stream_block_s": 0.5, "decode.kv_cache_dtype": "int8"},
], ids=["engine_beams", "stream_fps", "stream_int8"])
def test_serving_config_checks_equal_jax(over):
    with pytest.raises(ValueError) as ej:
        jload_config(TINY_YAML, over)
    with pytest.raises(ValueError) as et:
        tcfg.load_config(TINY_YAML, [f"{k}={v}" for k, v in over.items()])
    assert str(et.value) == str(ej.value)
    # the supported combinations validate
    tcfg.load_config(TINY_YAML, ["decode.engine_slots=2", "decode.kv_cache_dtype=int8"])
    tcfg.load_config(TINY_YAML, ["decode.stream_block_s=0.5", "model.modality=both"])
