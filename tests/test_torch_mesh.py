"""The port's mesh layer (``avsr_tpu_torch/mesh/``) and its data feeding
against the JAX package's (``avsr_tpu/mesh/``, ``data/loader.py``), on one
process (CPU).

Exact comparisons: ``local_rows`` and the loaders' ``data_shard`` checks
(values and messages), both datasets' ``length_hints``, the metadata
buckets, each leaf's sharding spec (the flagship, its QLoRA tree and its
MoE form, at full width from shapes alone), the mesh arithmetic and its
message. Sharded loaders of 2 and 4 ranks, concatenated, give the
one-process batches byte for byte (as ``tests/test_multihost.py`` holds
JAX's). The slices that ``shard_params`` keeps concatenate back to each
leaf bit for bit along the dimension the rule shards (the half-split int4
packing included). The multi-process runs are in
``test_torch_multirank.py``.
"""

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from avsr_tpu.core import config as jcfg
from avsr_tpu.data.dataset import ManifestAVSRDataset as JManifest
from avsr_tpu.data.dataset import SyntheticAVSRDataset as JSynthetic
from avsr_tpu.data.loader import DataLoader as JDataLoader
from avsr_tpu.data.loader import collate as jcollate
from avsr_tpu.data.tokenizer import ByteTokenizer as JByteTokenizer
from avsr_tpu.mesh import multihost as jmultihost
from avsr_tpu.mesh import sharding as jsharding
from avsr_tpu.models.avsr import init_avsr_model as jinit
from avsr_tpu.ops.quant import quantize_llm as jquantize_llm
from avsr_tpu_torch.core import config as tcfg
from avsr_tpu_torch.data.dataset import ManifestAVSRDataset, SyntheticAVSRDataset
from avsr_tpu_torch.data.loader import DataLoader, collate
from avsr_tpu_torch.data.manifest import ManifestEntry, write_manifest
from avsr_tpu_torch.data.tokenizer import ByteTokenizer
from avsr_tpu_torch.mesh import collectives, multihost, sharding
from avsr_tpu_torch.models.avsr import Batch, init_avsr_model
from avsr_tpu_torch.ops.quant import quantize_llm

from test_torch_train import port_paths

torch.set_num_threads(1)


def data_cfg(mod, **kw):
    base = dict(synthetic=True, synthetic_size=10, batch_size=4,
                max_audio_length=48000, max_video_length=8, max_label_length=32,
                audio_buckets=(100, 200, 300), video_buckets=(4, 8), num_workers=1)
    base.update(kw)
    return mod.DataConfig(**base)


def error(fn, *args, **kw):
    try:
        fn(*args, **kw)
    except (ValueError, NotImplementedError) as e:
        return type(e), str(e)
    return None


# ---------------------------------------------------------------------------
# rows, hints, buckets and loaders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args", [(8, (0, 4)), (8, (3, 4)), (12, (1, 2)), (6, (0, 4)),
                                  (8, (4, 4)), (8, (-1, 2))])
def test_local_rows_matches_jax(args):
    want = error(jmultihost.local_rows, *args) or jmultihost.local_rows(*args)
    got = error(multihost.local_rows, *args) or multihost.local_rows(*args)
    assert got == want


@pytest.mark.parametrize("modality", ["both", "audio", "video"])
def test_synthetic_length_hints_match_jax(modality):
    cfgs = [data_cfg(m, synthetic_size=12) for m in (jcfg, tcfg)]
    jds = JSynthetic(cfgs[0], JByteTokenizer(), modality=modality, image_size=16)
    tds = SyntheticAVSRDataset(cfgs[1], ByteTokenizer(), modality=modality, image_size=16)
    for i in range(len(tds)):
        hint = tds.length_hints(i)
        assert hint == jds.length_hints(i)
        s = tds[i]
        assert hint == (0 if s.audio is None else s.audio.shape[0],
                        0 if s.frames is None else s.frames.shape[0])


def test_manifest_length_hints_match_jax(tmp_path):
    entries = [ManifestEntry("u1", "v/u1.mp4", "a/u1.wav", 75, 48000),
               ManifestEntry("u2", "v/u2.mp4", "a/u2.wav", 50, 32000)]
    write_manifest(tmp_path / "train.tsv", tmp_path, entries)
    (tmp_path / "train.wrd").write_text("hello\nworld\n")
    kw = dict(path=str(tmp_path), synthetic=False)
    jds = JManifest(data_cfg(jcfg, **kw), JByteTokenizer(), modality="audio",
                    defer_audio=True)
    tds = ManifestAVSRDataset(data_cfg(tcfg, **kw), ByteTokenizer(), modality="audio",
                              defer_audio=True)
    # no media read: the files above do not exist
    assert [tds.length_hints(i) for i in range(2)] == [(48000, 75), (32000, 50)]
    assert [tds.length_hints(i) for i in range(2)] == [jds.length_hints(i) for i in range(2)]


def test_metadata_buckets_match_jax():
    """The buckets agreed from metadata equal JAX's on the same chunks, and
    the buckets that collating the chunk's samples picks."""
    cfgs = [data_cfg(m, synthetic_size=24, max_video_length=16,
                     video_buckets=(4, 8, 16)) for m in (jcfg, tcfg)]
    jl = JDataLoader(JSynthetic(cfgs[0], JByteTokenizer(), image_size=8), cfgs[0],
                     JByteTokenizer(), data_shard=(0, 2))
    tds = SyntheticAVSRDataset(cfgs[1], ByteTokenizer(), image_size=8)
    tl = DataLoader(tds, cfgs[1], ByteTokenizer(), model_cfg=tcfg.ModelConfig(),
                    device="cpu", data_shard=(0, 2))
    rng = np.random.default_rng(0)
    for _ in range(12):
        chunk = rng.choice(24, size=int(rng.integers(1, 9)), replace=False)
        got = tl._metadata_buckets(chunk)
        assert got == jl._metadata_buckets(chunk)
        hb = collate([tds[int(i)] for i in chunk], cfgs[1], [1], 0)
        assert got == (hb.audio.shape[1] // 160, hb.frames.shape[1])


def test_collate_to_given_buckets_matches_jax():
    cfgs = [data_cfg(m) for m in (jcfg, tcfg)]
    samples = [SyntheticAVSRDataset(cfgs[1], ByteTokenizer(), image_size=8)[i]
               for i in range(3)]
    kw = dict(audio_bucket=300, video_bucket=8)
    want = jcollate(samples, cfgs[0], [256, 7], 0, **kw)
    got = collate(samples, cfgs[1], [256, 7], 0, **kw)
    assert got.audio.shape == (3, 300 * 160) and got.frames.shape[1] == 8
    for f in ("audio", "audio_lens", "frames", "frame_lens", "labels", "label_lens",
              "prompt"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


@pytest.mark.parametrize("world,compact", [(2, False), (4, False), (2, True), (4, True)])
def test_sharded_loaders_reassemble_one_process(world, compact):
    """``world`` loaders with ``data_shard``, concatenated, give the
    one-process loader's batches byte for byte, the wrap-padded last batch
    (10 % 4) included: its repeated rows have label length 0 on whichever
    rank holds them."""
    cfg = data_cfg(tcfg, compact_transfer=compact)
    tok = ByteTokenizer()
    mc = tcfg.ModelConfig(prompt="t:")

    def batches(shard):
        ds = SyntheticAVSRDataset(cfg, tok, image_size=16)
        loader = DataLoader(ds, cfg, tok, model_cfg=mc, seed=3, device="cpu",
                            data_shard=shard)
        return [hb for hb, _ in loader]

    full = batches(None)
    parts = [batches((i, world)) for i in range(world)]
    assert all(len(p) == len(full) == 3 for p in parts)
    fields = ("audio", "audio_lens", "labels", "label_lens", "prompt")
    fields += ("frames_y", "frames_uv") if compact else ("frames", "frame_lens")
    for b, f in enumerate(full):
        rows = [p[b] for p in parts]
        assert all(len(r.utt_ids) == 4 // world for r in rows)
        assert sum((r.utt_ids for r in rows), []) == f.utt_ids
        for name in fields:
            np.testing.assert_array_equal(
                np.concatenate([getattr(r, name) for r in rows]), getattr(f, name),
                err_msg=f"batch {b} {name}")
    assert (full[-1].label_lens[2:] == 0).all() and (full[-1].label_lens[:2] > 0).all()


def test_data_shard_validation_matches_jax():
    cfgs = [data_cfg(m, batch_size=4) for m in (jcfg, tcfg)]

    class NoHints:
        def __len__(self):
            return 4

    for shard, ds in (((0, 3), None), ((2, 2), None), ((0, 2), NoHints())):
        want = error(JDataLoader, ds or JSynthetic(cfgs[0], JByteTokenizer(), image_size=8),
                     cfgs[0], JByteTokenizer(), data_shard=shard)
        got = error(DataLoader, ds or SyntheticAVSRDataset(cfgs[1], ByteTokenizer(),
                                                           image_size=8),
                    cfgs[1], ByteTokenizer(), model_cfg=tcfg.ModelConfig(), device="cpu",
                    data_shard=shard)
        assert want is not None and got == want


# ---------------------------------------------------------------------------
# the mesh and the rule table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,axes", [
    (4, dict(dp=-1)), (4, dict(dp=-1, fsdp=2)), (8, dict(dp=2, fsdp=2, dcn_dp=2)),
    (4, dict(dp=3)), (4, dict(dp=-1, fsdp=3)), (2, dict(dp=1, fsdp=1)),
    (6, dict(dp=2, fsdp=2, dcn_dp=2))])
def test_mesh_shape_matches_jax(n, axes):
    """dp=-1 infers from the world; a product other than it raises JAX's
    message."""
    want = error(jsharding.build_mesh, jcfg.MeshConfig(**axes), devices=jax.devices()[:n])
    got = error(sharding.mesh_shape, tcfg.MeshConfig(**axes), n)
    if want is None:
        assert got is None
        assert sharding.mesh_shape(tcfg.MeshConfig(**axes), n) == dict(
            jsharding.build_mesh(jcfg.MeshConfig(**axes), devices=jax.devices()[:n]).shape)
    else:
        assert got == want


@pytest.mark.parametrize("over", ["mesh.tp=2", "mesh.sp=2", "mesh.pp=2",
                                  "mesh.ep=2 model.connector_type=moe"])
def test_model_axes_are_the_next_slice(over):
    """Every model axis loads since the ep slice: tp, sp, pp and ep with
    MoE (each needs 2 processes: JAX's mesh message at a world of 1); pp
    with the default LoRA dropout and ep with a dense model raise JAX's
    messages; the data axes load."""
    if over == "mesh.pp=2":
        with pytest.raises(ValueError, match="lora.dropout > 0"):
            tcfg.load_config(None, [over])
        over = "mesh.pp=2 model.lora.dropout=0"
    if over.startswith("mesh.ep"):
        with pytest.raises(ValueError, match="requires MoE somewhere"):
            tcfg.load_config(None, ["mesh.ep=2"])
        assert tcfg.load_config(None, over.split()).mesh.ep == 2
    with pytest.raises(ValueError, match="devices"):
        sharding.mesh_shape(tcfg.load_config(None, over.split()).mesh, 1)
    cfg = tcfg.load_config(None, ["mesh.dp=2", "mesh.fsdp=2", "mesh.dcn_dp=2"])
    assert (cfg.mesh.dp, cfg.mesh.fsdp, cfg.mesh.dcn_dp) == (2, 2, 2)


def test_moe_refused_across_processes():
    """Mixture of experts is no longer refused across processes (nor under
    tp): ``check_model`` accepts both MoE forms of the flagship at every
    axis JAX allows, and refuses only LLM MoE blocks under pp, with JAX's
    message (the ``moe`` connector runs under pp)."""
    moe = tcfg.flagship(MOE).model
    sharding.check_model(moe, tp=2)
    sharding.check_model(tcfg.load_config(None, ["model.connector_type=moe"]).model, pp=2)
    with pytest.raises(ValueError, match="GPipe stage scan does not thread MoE aux"):
        sharding.check_model(moe, pp=2)
    sharding.check_model(tcfg.flagship().model)


MOE = ["model.connector_type=moe", "model.llm.moe_experts=8", "model.llm.moe_topk=2",
       "model.llm.moe_every=2"]


@pytest.mark.parametrize("form", ["flagship", "qlora", "moe"])
def test_param_specs_match_jax(form):
    """Every leaf of the flagship's tree (its int4 QLoRA tree; its MoE
    form) gets the spec JAX's ``param_spec`` gives it, at full width, from
    shapes alone."""
    over = MOE if form == "moe" else []
    jc = jcfg.load_config("avsr_tpu/configs/base.yaml", over)
    tc = tcfg.flagship(over)

    def jtree():
        p = jinit(jax.random.key(0), jc.model)
        return {**p, "llm": jquantize_llm(p["llm"], 4)} if form == "qlora" else p

    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jax.eval_shape(jtree))[0]:
        key = tuple(str(getattr(k, "key", getattr(k, "idx", ""))) for k in path)
        want[key] = tuple(jsharding.param_spec(path, leaf))
    with FakeTensorMode():
        p = init_avsr_model(tc.model, device="cpu")
        if form == "qlora":
            p = {**p, "llm": quantize_llm(p["llm"], 4)}
    got = {k: sharding.param_spec(k, v) for k, v in port_paths(p).items()}
    assert got.keys() == want.keys()
    assert got == want
    names = {k[-1] for k in got}
    assert ("qw4h" in names) == (form == "qlora") and ("w_gate" in names) == (form == "moe")
    assert any("fsdp" in s for s in got.values())


def echo_mesh(rank: int, fsdp: int = 2) -> sharding.Mesh:
    g = collectives.EchoGroup(fsdp, rank)
    one = collectives.EchoGroup(1, 0)
    shape = dict(zip(sharding.AXES, (1, 1, fsdp, 1, 1, 1, 1)))
    return sharding.Mesh(shape, rank, world=g, data=g, fsdp=g, replica=one, tp=one)


def test_slices_concatenate_back_to_each_leaf():
    """The slices that the fsdp ranks keep concatenate, along the dimension
    the rule shards, back to every leaf bit for bit: the half-split int4
    packing (``qw4h``, rows k and k + K/2 in one byte) of q/k/v/gate/up
    along dim 0 and of o/down along dim 1, their scales, the embedding."""
    cfg = tcfg.load_config("avsr_tpu/configs/tiny_cpu.yaml", [
        "model.llm.d_model=64", "model.llm.ffn_dim=128", "model.llm.n_layers=1"])
    p = init_avsr_model(cfg.model, seed=0, device="cpu")
    p = {**p, "llm": quantize_llm(p["llm"], 4)}
    parts = [sharding.shard_params(p, echo_mesh(r)) for r in range(2)]
    full, halves = port_paths(p), [port_paths(q) for q in parts]
    dims = {}
    for k, leaf in full.items():
        s = sharding.shard_of(halves[0][k])
        if s is None:
            assert halves[0][k] is leaf and halves[1][k] is leaf
            continue
        dims[k[-2:]] = s.dim
        assert s.full == leaf.shape[s.dim] and sharding.full_shape(halves[0][k]) == leaf.shape
        assert torch.equal(torch.cat([h[k] for h in halves], dim=s.dim), leaf), k
    assert dims[("q", "qw4h")] == 0 and dims[("down", "qw4h")] == 1
    assert dims[("down", "scale")] == 0 and ("q", "scale") not in dims
    assert dims[("llm", "embed")] == 1


def test_shard_params_refuses_a_dimension_that_does_not_divide():
    cfg = tcfg.load_config("avsr_tpu/configs/tiny_cpu.yaml", [])
    p = init_avsr_model(cfg.model, seed=0, device="cpu")
    with pytest.raises(ValueError, match="should be divisible by 3"):
        sharding.shard_params(p, echo_mesh(0, fsdp=3))


@pytest.mark.parametrize("dim", [0, 1, 2])
def test_collective_layouts_round_trip(dim):
    """A reduce-scatter reads the chunks along ``dim`` one after another
    (rank i's chunk i); a gather lays them back along ``dim``."""
    x = torch.arange(4 * 6 * 2, dtype=torch.float32).reshape(4, 6, 2)
    chunks = x.chunk(2, dim=dim)
    flat = collectives._split(x, 2, dim)
    assert torch.equal(flat, torch.cat(chunks, dim=0))
    assert torch.equal(collectives._join(flat, 2, dim), x)


def test_pad_and_take_rows():
    """A decode batch that does not divide the ways is padded with its
    last row; each rank's rows are contiguous."""
    b = Batch(mel=torch.arange(5.0)[:, None].expand(5, 3), labels=torch.arange(5)[:, None],
              prompt_tokens=torch.zeros(5, 2, dtype=torch.int32))
    padded, n = sharding.pad_rows(b, 2)
    assert n == 5 and padded.mel.shape == (6, 3) and padded.labels[:, 0].tolist() == [
        0, 1, 2, 3, 4, 4]
    lo, hi = multihost.local_rows(6, (1, 2))
    assert sharding.take_rows(padded, lo, hi).labels[:, 0].tolist() == [3, 4, 4]
    same, n = sharding.pad_rows(b, 5)
    assert same.mel is b.mel and n == 5


def test_no_environment_is_the_single_card_port(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert multihost.init_distributed("cpu") == (torch.device("cpu"), None)
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert multihost.init_distributed("cpu") == (torch.device("cpu"), None)
    assert not torch.distributed.is_initialized()
    assert multihost.process_shard() == (0, 1)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit, match="one card"):
        multihost.refuse_world("the serve CLI")


# ---------------------------------------------------------------------------
# a rank's rows of one card's random draws
# ---------------------------------------------------------------------------

def four_rows(seed: int = 0) -> Batch:
    rng = np.random.default_rng(seed)
    return Batch(
        mel=torch.from_numpy(rng.standard_normal((4, 80, 400)).astype(np.float32)),
        mel_lens=torch.tensor([400, 300, 350, 200], dtype=torch.int32),
        frames=torch.from_numpy(rng.standard_normal((4, 4, 3, 16, 16)).astype(np.float32)),
        frame_lens=torch.tensor([4, 3, 2, 4], dtype=torch.int32),
        prompt_tokens=torch.tensor([[256, 72, 105, 33, 9]] * 4, dtype=torch.int32),
        labels=torch.from_numpy(rng.integers(0, 258, (4, 24)).astype(np.int32)),
        label_lens=torch.tensor([24, 17, 20, 9], dtype=torch.int32))


@pytest.mark.parametrize("lo,hi", [(0, 2), (2, 4), (1, 3), (3, 4)])
def test_augmentation_rows_are_one_card_rows(lo, hi):
    """SpecAugment's and video augmentation's draws for a rank's rows of a
    global batch are those rows of the single card's draws."""
    from avsr_tpu_torch.train.step import augment

    cfg = tcfg.load_config("avsr_tpu/configs/tiny_cpu.yaml", [
        "model.modality=both", "data.specaugment=true", "data.video_augment=true",
        "data.spec_time_width=20"])
    full = four_rows()
    whole, seed = augment(cfg, full, 9)
    part, seed_part = augment(cfg, sharding.take_rows(full, lo, hi), 9,
                              sharding.RowShard(lo, 4, collectives.EchoGroup(1, 0)))
    assert seed_part == seed
    assert not torch.equal(whole.mel, full.mel) and not torch.equal(whole.frames, full.frames)
    assert torch.equal(part.mel, whole.mel[lo:hi])
    assert torch.equal(part.frames, whole.frames[lo:hi])


@pytest.mark.parametrize("lo,hi", [(0, 2), (2, 4), (1, 4)])
def test_dropout_masks_are_one_card_rows(lo, hi):
    """The LLM's LoRA dropout masks of rows [lo, hi) of a batch, drawn by a
    rank that holds only those rows, are the single card's: each row's
    masks come from a generator of its own global row."""
    from avsr_tpu_torch.models import llama as tllama

    cfg = tcfg.load_config("avsr_tpu/configs/tiny_cpu.yaml", [
        "model.llm.n_layers=2", "model.lora.dropout=0.5"])
    p = init_avsr_model(cfg.model, seed=0, device="cpu")["llm"]
    for layer in p["layers"]:
        for node in layer.values():
            if "lora" in node:
                node["lora"]["b"].normal_(0, 0.5, generator=torch.Generator().manual_seed(1))
    x = torch.randn((4, 20, cfg.model.llm.d_model), generator=torch.Generator().manual_seed(2))
    lens = torch.tensor([20, 15, 11, 18])
    kw = dict(lora=cfg.model.lora, dropout_seed=5, output="hidden")
    whole, _ = tllama.llama_apply(p, cfg.model.llm, inputs_embeds=x, lengths=lens, **kw)
    none, _ = tllama.llama_apply(p, cfg.model.llm, inputs_embeds=x, lengths=lens,
                                 lora=cfg.model.lora, output="hidden")
    part, _ = tllama.llama_apply(p, cfg.model.llm, inputs_embeds=x[lo:hi], lengths=lens[lo:hi],
                                 dropout_row0=lo, **kw)
    assert not torch.allclose(whole, none)
    torch.testing.assert_close(part, whole[lo:hi], atol=1e-6, rtol=1e-6)


ONE_CARD_CLIS = {
    "serve": [], "stream": ["--audio", "u.wav"], "infer": ["--audio", "u.wav"],
    "validate": ["--synthetic"], "profile": [], "analyze_memory": [],
    "average": ["--checkpoint", "ck", "--out", "o"], "convert_hf": ["--out", "o"],
    "convert_ref_ckpt": ["--checkpoint", "ck.pt", "--out", "o"],
    "distill": ["--teacher-config", "t.json", "--teacher-checkpoint", "ck", "--out", "o"],
    "prepare_data": ["--out", "o"], "parity": [],
    "decode": ["decode.engine_slots=2"]}


@pytest.mark.parametrize("name", sorted(ONE_CARD_CLIS))
def test_one_card_clis_refuse_a_world_above_one(name, monkeypatch, tmp_path):
    """Started in a world of 2, every CLI but train and decode (and the
    decode CLI's engine) stops, saying it runs on one card, before it
    reads a file or makes a process group."""
    import importlib

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    mod = importlib.import_module(f"avsr_tpu_torch.cli.{name}")
    with pytest.raises(SystemExit, match="runs on one card: WORLD_SIZE=2"):
        mod.main(["--device", "cpu", *ONE_CARD_CLIS[name]] if name != "prepare_data"
                 else ONE_CARD_CLIS[name])
    assert not torch.distributed.is_initialized() and not list(tmp_path.iterdir())
