"""The port's HF converters (``cli/convert_hf.py`` over ``core/hf_files.py``)
against the JAX package's, which reads the same directories through
``transformers.<Class>.from_pretrained`` (CPU).

Tiny random-init Whisper, CLIP, Llama and HuBERT/Wav2Vec2 checkpoints are
written with ``save_pretrained`` in three layouts: ``model.safetensors``,
``pytorch_model.bin`` (with the model classes that add a base-model prefix,
a tied Llama read by an untied config, and the legacy ``weight_g`` /
``weight_v`` positional conv) and sharded files behind an ``*.index.json``
(a bf16 tied Llama, which ``from_pretrained`` upcasts). Every converted
leaf must equal JAX's exactly, dtype included, except the positional conv,
which both packages compute as g * v / ||v|| in f32 (rtol 1e-6, atol
1e-7). Fresh leaves (connectors, LoRA ``a``; each package draws its own)
match in key path, shape and dtype, and LoRA ``b`` is zero. End to end,
each package's ``convert_hf --out`` then decode ``--checkpoint`` gives the
same hypotheses (f32, greedy) once the port's export carries JAX's fresh
leaves. The video encoders' checkpoints: ResNet and EfficientNet
directories (base and ``*ForImageClassification`` models) and a
fairseq-layout AV-HuBERT ``.pt``, held leaf for leaf the same way.
"""

import jax
import numpy as np
import pytest
import torch

from avsr_tpu.cli import common as jcommon
from avsr_tpu.cli import convert_hf as jconvert
from avsr_tpu.cli import decode as jcli_decode
from avsr_tpu.core.config import load_config as jload_config
from avsr_tpu_torch.cli import convert_hf as tconvert
from avsr_tpu_torch.cli import decode as tcli_decode
from avsr_tpu_torch.convert import from_numpy_tree
from avsr_tpu_torch.core import config as tcfg
from avsr_tpu_torch.core import hf_files
from avsr_tpu_torch.train.checkpoint import export_params, load_params

from test_torch_checkpoint_cli import hyp_lines
from test_torch_train import jax_paths, port_paths

torch.set_num_threads(1)

SSL_HF = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
              intermediate_size=128, conv_dim=[32, 32, 32], conv_kernel=[10, 3, 3],
              conv_stride=[5, 2, 2], num_conv_pos_embeddings=16,
              num_conv_pos_embedding_groups=2, num_feat_extract_layers=3, vocab_size=32)
LARGE_HF = dict(conv_bias=True, feat_extract_norm="layer", do_stable_layer_norm=True)
LAYOUTS = ("safetensors", "bin", "sharded")


def _legacy_weight_norm(directory):
    """Rewrite a ``pytorch_model.bin`` with the positional conv's weight
    norm under its legacy names, as older checkpoints hold it."""
    path = directory / "pytorch_model.bin"
    sd = torch.load(path, weights_only=True)
    ren = {".parametrizations.weight.original0": ".weight_g",
           ".parametrizations.weight.original1": ".weight_v"}
    out = {}
    for k, v in sd.items():
        for a, b in ren.items():
            k = k.replace(a, b)
        out[k] = v
    assert any(k.endswith("weight_g") for k in out)
    torch.save(out, path)


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    """{layout: root} of tiny HF directories: whisper, clip, llm, ssl."""
    from transformers import (CLIPConfig, CLIPModel, CLIPVisionConfig, CLIPVisionModel,
                              HubertConfig, HubertForCTC, HubertModel, LlamaConfig,
                              LlamaForCausalLM, Wav2Vec2Config, Wav2Vec2Model,
                              WhisperConfig, WhisperForConditionalGeneration,
                              WhisperModel)

    wcfg = WhisperConfig(num_mel_bins=80, d_model=32, encoder_layers=2,
                         encoder_attention_heads=2, decoder_layers=1,
                         decoder_attention_heads=2, encoder_ffn_dim=128,
                         decoder_ffn_dim=128, max_source_positions=50, vocab_size=100,
                         pad_token_id=0, bos_token_id=1, eos_token_id=2,
                         decoder_start_token_id=1)
    vis = dict(hidden_size=24, num_hidden_layers=2, num_attention_heads=2,
               intermediate_size=96, image_size=16, patch_size=8)

    def llama(tied):
        return LlamaForCausalLM(LlamaConfig(
            vocab_size=260, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, intermediate_size=64, tie_word_embeddings=tied,
            attention_bias=False, mlp_bias=False)).eval()

    out = {}
    for i, layout in enumerate(LAYOUTS):
        root = tmp_path_factory.mktemp(layout)
        torch.manual_seed(i)
        kw = {"safetensors": {}, "bin": dict(safe_serialization=False),
              "sharded": dict(max_shard_size="30KB")}[layout]
        if layout == "bin":
            WhisperForConditionalGeneration(wcfg).eval().save_pretrained(root / "whisper", **kw)
            CLIPModel(CLIPConfig(vision_config=vis, text_config=dict(
                hidden_size=16, num_hidden_layers=1, num_attention_heads=2,
                intermediate_size=32, vocab_size=64))).eval().save_pretrained(root / "clip", **kw)
            llama(True).save_pretrained(root / "llm", **kw)
            Wav2Vec2Model(Wav2Vec2Config(**SSL_HF, **LARGE_HF)).eval().save_pretrained(
                root / "ssl", **kw)
            _legacy_weight_norm(root / "ssl")
        else:
            WhisperModel(wcfg).eval().save_pretrained(root / "whisper", **kw)
            CLIPVisionModel(CLIPVisionConfig(**vis)).eval().save_pretrained(root / "clip", **kw)
            llm = llama(layout == "sharded")
            (llm.to(torch.bfloat16) if layout == "sharded" else llm).save_pretrained(
                root / "llm", **kw)
            ssl = (HubertForCTC if layout == "sharded" else HubertModel)(HubertConfig(**SSL_HF))
            ssl.eval().save_pretrained(root / "ssl", **kw)
        out[layout] = root
    # the layouts are what they claim
    assert (out["sharded"] / "llm" / "model.safetensors.index.json").exists()
    assert (out["bin"] / "llm" / "pytorch_model.bin").exists()
    assert "lm_head.weight" not in hf_files.read_weights(out["sharded"] / "llm")
    return out


MODEL = {"model.whisper.d_model": 32, "model.whisper.n_heads": 2,
         "model.whisper.n_layers": 2, "model.whisper.max_frames": 100,
         "model.clip.image_size": 16, "model.clip.patch_size": 8,
         "model.clip.d_model": 24, "model.clip.n_heads": 2, "model.clip.n_layers": 2,
         "model.ssl.d_model": 32, "model.ssl.n_heads": 2, "model.ssl.n_layers": 2,
         "model.ssl.conv_dims": "[32,32,32]", "model.ssl.conv_kernels": "[10,3,3]",
         "model.ssl.conv_strides": "[5,2,2]", "model.ssl.pos_conv_kernel": 16,
         "model.ssl.pos_conv_groups": 2,
         "model.llm.vocab_size": 260, "model.llm.d_model": 32, "model.llm.n_layers": 2,
         "model.llm.n_heads": 4, "model.llm.n_kv_heads": 2, "model.llm.ffn_dim": 64,
         "model.llm.max_seq_len": 1024, "model.lora.r": 2, "model.lora.alpha": 4,
         "data.audio_buckets": "[100]", "data.video_buckets": "[4]",
         "data.synthetic": "true", "data.synthetic_size": 8, "data.batch_size": 8,
         "data.max_label_length": 24, "runtime.compute_dtype": "float32",
         "mesh.remat": "false", "decode.max_new_tokens": 6, "decode.batch_size": 8}


def _over(**extra) -> list[str]:
    return [f"{k}={v}" for k, v in {**MODEL, **extra}.items()]


def _paths(root, kind: str) -> dict:
    """The overrides of one config over the directories of one layout:
    "av" (Whisper + CLIP + Llama) or "ssl" (HuBERT/Wav2Vec2 + Llama)."""
    tied = (root / "llm" / "model.safetensors.index.json").exists()
    ssl_extra = {}
    if (root / "ssl" / "pytorch_model.bin").exists():        # the wav2vec2-large geometry
        ssl_extra = {"model.audio_encoder": "wav2vec2", "model.ssl.conv_bias": "true",
                     "model.ssl.feat_extract_norm": "layer",
                     "model.ssl.do_stable_layer_norm": "true"}
    common = {"model.llm_path": root / "llm",
              "model.llm.tie_embeddings": str(tied).lower()}
    if kind == "av":
        return {**common, "model.modality": "both", "model.whisper_path": root / "whisper",
                "model.clip_path": root / "clip"}
    return {**common, "model.modality": "audio", "model.audio_encoder": "hubert",
            "model.audio_encoder_path": root / "ssl", **ssl_extra}


def _compare(p_j, p_t, notes):
    got, want = port_paths(p_t), jax_paths(p_j)
    assert got.keys() == want.keys()
    converted = {n.split("+")[0] for n in notes}
    for k, w in want.items():
        g, w = got[k], np.asarray(w)
        assert g.dtype == torch.float32 and w.dtype == np.float32, k
        assert tuple(g.shape) == w.shape, k
        if k[0] not in converted or (k[0] == "llm" and k[-1] == "a"):
            continue                                    # fresh leaves
        if k[-2:] == ("pos_conv", "w"):                 # g * v / ||v|| in f32
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-7, err_msg=str(k))
        else:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=str(k))
    lora_b = [v for k, v in got.items() if k[-1] == "b" and "lora" in k]
    assert lora_b and all(not v.any() for v in lora_b)


@pytest.mark.parametrize("kind", ["av", "ssl"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_converted_tree_equals_jax(hf_dirs, layout, kind):
    over = _over(**_paths(hf_dirs[layout], kind))
    jc, tc = jload_config(None, over), tcfg.load_config(None, over)
    p_j, notes_j = jconvert.build_converted_params(jc)
    p_t, notes_t = tconvert.build_converted_params(tc, device="cpu")
    assert notes_t == notes_j
    assert len(notes_t) == (3 if kind == "av" else 2)
    _compare(p_j, p_t, notes_t)
    if kind == "av" and layout == "bin":   # a tied file read by an untied config
        assert torch.equal(p_t["llm"]["lm_head"]["w"], p_t["llm"]["embed"].T)


def test_safetensors_reader_matches_the_library(hf_dirs):
    """The hand-written reader gives the ``safetensors`` package's tensors,
    bf16 shards included."""
    from safetensors.torch import load_file

    for f in [hf_dirs["safetensors"] / "ssl" / "model.safetensors",
              *sorted((hf_dirs["sharded"] / "llm").glob("*.safetensors"))]:
        ours, ref = hf_files.read_safetensors(f), load_file(f)
        assert ours.keys() == ref.keys()
        for k in ref:
            assert ours[k].dtype == ref[k].dtype and torch.equal(ours[k], ref[k]), (f, k)
    sd, hf = hf_files.load_pretrained(hf_dirs["sharded"] / "llm")
    assert hf["tie_word_embeddings"] and sd["lm_head.weight"] is sd["model.embed_tokens.weight"]
    assert all(v.dtype == torch.float32 for v in sd.values())


@pytest.mark.parametrize("component,key", [
    ("whisper", "model.whisper.d_model=48"), ("clip", "model.clip.d_model=48"),
    ("llm", "model.llm.d_model=64"), ("hubert", "model.ssl.d_model=64")])
def test_dim_mismatch_errors_match_jax(hf_dirs, component, key):
    over = _over(**_paths(hf_dirs["safetensors"], "ssl" if component == "hubert" else "av"))
    if component == "llm":
        over += ["model.llm.n_heads=4"]
    errs = []
    for build in (lambda: jconvert.build_converted_params(jload_config(None, over + [key])),
                  lambda: tconvert.build_converted_params(tcfg.load_config(None, over + [key]),
                                                          device="cpu")):
        with pytest.raises(ValueError, match="d_model mismatch") as e:
            build()
        errs.append(str(e.value))
    assert errs[0] == errs[1] and errs[0].startswith(component)


VIDEO = {"resnet": {"model.resnet.image_size": 32, "model.resnet.embedding_size": 16,
                    "model.resnet.hidden_sizes": "[32,64]", "model.resnet.depths": "[1,2]"},
         "efficientnet": {"model.efficientnet.image_size": 32,
                          "model.efficientnet.in_channels": "[32,16]",
                          "model.efficientnet.out_channels": "[16,24]",
                          "model.efficientnet.kernel_sizes": "[3,5]",
                          "model.efficientnet.strides": "[1,2]",
                          "model.efficientnet.num_block_repeats": "[1,2]",
                          "model.efficientnet.expand_ratios": "[1,6]"},
         "avhubert": {"model.avhubert.image_size": 32, "model.avhubert.frontend_channels": 8,
                      "model.avhubert.trunk_widths": "[8,16,24,32]",
                      "model.avhubert.trunk_depths": "[1,1,1,1]",
                      "model.avhubert.d_model": 32, "model.avhubert.n_heads": 4,
                      "model.avhubert.n_layers": 2, "model.avhubert.ffn_mult": 2,
                      "model.avhubert.pos_conv_kernel": 16,
                      "model.avhubert.pos_conv_groups": 4}}


@pytest.fixture(scope="module")
def video_ckpts(tmp_path_factory):
    """{encoder: [checkpoint, ...]}: tiny random ResNet and EfficientNet
    directories that ``transformers`` writes (the base model in one layout,
    the ``*ForImageClassification`` model, with its ``resnet.`` /
    ``efficientnet.`` prefix, classifier and ``num_batches_tracked``, in the
    other), and a fairseq-layout AV-HuBERT ``.pt`` whose config object's
    class cannot be imported when it is read."""
    import sys
    import types

    from transformers import (EfficientNetConfig, EfficientNetForImageClassification,
                              EfficientNetModel, ResNetConfig, ResNetForImageClassification,
                              ResNetModel)

    from test_avhubert_fairseq import _AVHubertOracle, _randomize

    def randomize(model):
        """Random BatchNorm statistics (init leaves them 0 and 1)."""
        g = torch.Generator().manual_seed(5)
        with torch.no_grad():
            for k, t in model.state_dict().items():
                if k.endswith("running_var"):
                    t.copy_(torch.rand(t.shape, generator=g) + 0.5)
                elif k.endswith("running_mean"):
                    t.copy_(0.1 * torch.randn(t.shape, generator=g))
        return model.eval()

    root = tmp_path_factory.mktemp("video")
    rc = ResNetConfig(num_channels=3, embedding_size=16, hidden_sizes=[32, 64], depths=[1, 2],
                      layer_type="bottleneck", num_labels=5)
    ec = EfficientNetConfig(image_size=32, width_coefficient=1.0, depth_coefficient=1.0,
                            in_channels=[32, 16], out_channels=[16, 24],
                            kernel_sizes=[3, 5], strides=[1, 2], num_block_repeats=[1, 2],
                            expand_ratios=[1, 6], depthwise_padding=[], hidden_dim=1280,
                            num_labels=5)
    torch.manual_seed(0)
    out = {"resnet": [], "efficientnet": [], "avhubert": []}
    for name, cls, cfg, kw in (
            ("resnet_base", ResNetModel, rc, {}),
            ("resnet_cls", ResNetForImageClassification, rc, dict(safe_serialization=False)),
            ("efficientnet_base", EfficientNetModel, ec, dict(safe_serialization=False)),
            ("efficientnet_cls", EfficientNetForImageClassification, ec, {})):
        randomize(cls(cfg)).save_pretrained(root / name, **kw)
        out[name.split("_")[0]].append(root / name)
    assert "resnet.embedder.embedder.convolution.weight" in hf_files.read_weights(
        root / "resnet_cls")
    assert "classifier.weight" in hf_files.read_weights(root / "efficientnet_cls")

    oracle = _AVHubertOracle("concat", False).eval()
    _randomize(oracle)
    mod = types.ModuleType("fake_fairseq_cfg_pkg")
    exec("class FakeDictConfig:\n    def __init__(self):\n        self.x = {'y': 1}\n",
         mod.__dict__)
    sys.modules["fake_fairseq_cfg_pkg"] = mod
    try:
        torch.save({"model": oracle.state_dict(), "cfg": mod.FakeDictConfig()},
                   root / "avhubert.pt")
    finally:
        del sys.modules["fake_fairseq_cfg_pkg"]
    out["avhubert"].append(root / "avhubert.pt")
    return out


@pytest.mark.parametrize("encoder", ["resnet", "efficientnet", "avhubert"])
def test_video_encoder_converters_equal_jax(video_ckpts, encoder):
    """``model.video_encoder_path`` through each package's
    ``build_converted_params``: every converted leaf equals JAX's (the
    AV-HuBERT positional conv's g * v / ||v|| to f32 rounding), and the
    configured width must match the checkpoint's, with JAX's message."""
    for ckpt in video_ckpts[encoder]:
        over = _over(**{"model.modality": "video", "model.video_encoder": encoder,
                        "model.video_encoder_path": ckpt, **VIDEO[encoder]})
        p_j, notes_j = jconvert.build_converted_params(jload_config(None, over))
        p_t, notes_t = tconvert.build_converted_params(tcfg.load_config(None, over),
                                                       device="cpu")
        assert notes_t == notes_j == [encoder]
        _compare(p_j, p_t, notes_t)
        assert not any("num_batches_tracked" in "/".join(k) for k in port_paths(p_t))
    bad = {"resnet": ["model.resnet.hidden_sizes=[32,128]"],
           # a b2-wide top (1408) over the b0-wide checkpoint's 1280
           "efficientnet": ["model.efficientnet.width_coefficient=1.1",
                            "model.efficientnet.hidden_dim=1408"]}.get(encoder)
    if bad:
        errs = []
        for build in (lambda: jconvert.build_converted_params(jload_config(None, over + bad)),
                      lambda: tconvert.build_converted_params(
                          tcfg.load_config(None, over + bad), device="cpu")):
            with pytest.raises(ValueError, match="mismatch") as e:
                build()
            errs.append(str(e.value))
        assert errs[0] == errs[1] and errs[0].startswith(encoder)


@pytest.mark.parametrize("kind", ["av", "ssl"])
def test_convert_cli_then_decode_matches_jax(hf_dirs, tmp_path, kind):
    """convert_hf --out, then decode --checkpoint, in each package: the
    exports' converted leaves are equal, and with the port's fresh leaves
    (the connectors, LoRA a) set to JAX's, the HYP lines are too."""
    layout = "sharded" if kind == "av" else "bin"
    paths = _paths(hf_dirs[layout], kind)
    conv = _over(**paths)
    dec = {k: v for k, v in paths.items() if not k.endswith("_path")}

    def decode_over(d):
        return _over(**dec, **{"decode.output_dir": tmp_path / d})

    assert jconvert.main(["--out", str(tmp_path / "jexp"), *conv]) == 0
    assert tconvert.main(["--device", "cpu", "--out", str(tmp_path / "texp"), *conv]) == 0
    jc, tc = jload_config(None, decode_over("jdec")), tcfg.load_config(None, decode_over("tdec"))
    p_j = jax.tree_util.tree_map(np.asarray,
                                 jcommon.init_or_load_params(jc, str(tmp_path / "jexp")))
    p_t = load_params(tmp_path / "texp")
    notes = ["whisper", "clip", "llm"] if kind == "av" else ["wav2vec2", "llm"]
    _compare(p_j, p_t, notes)
    fresh = {k: v for k, v in jax_paths(p_j).items()
             if k[0] not in notes or (k[0] == "llm" and k[-1] == "a")}
    synced = from_numpy_tree(p_j, "cpu")
    for k, v in port_paths(p_t).items():
        if k not in fresh:
            node = synced
            for part in k[:-1]:
                node = node[int(part)] if isinstance(node, list) else node[part]
            node[k[-1]] = v
    export_params(synced, tmp_path / "texp_synced")

    assert jcli_decode.main(["--checkpoint", str(tmp_path / "jexp"), "--split", "train",
                             *decode_over("jdec")]) == 0
    assert tcli_decode.main(["--device", "cpu", *decode_over("tdec"), "--checkpoint",
                             str(tmp_path / "texp_synced"), "--split", "train"]) == 0
    hyps = hyp_lines(tmp_path / "tdec")
    assert len(hyps) == 8 and hyps == hyp_lines(tmp_path / "jdec")


def test_chip_smoke_writer_key_map(tmp_path):
    """``chip_smoke.py`` writes HF directories without ``transformers``
    (the card's host has none): at a tiny width, ``from_pretrained`` must
    load each with no unexpected key and no missing one but the heads and
    decoders the writer leaves out; JAX's conversion of the directories
    equals the port's, and the port's gives the written trees back (the
    positional conv within f32 rounding)."""
    import chip_smoke
    from transformers import (CLIPVisionModel, HubertModel, LlamaForCausalLM,
                              WhisperForConditionalGeneration)

    from avsr_tpu_torch.models.clip_vit import init_clip_vit
    from avsr_tpu_torch.models.hubert import init_speech_ssl
    from avsr_tpu_torch.models.llama import init_llama
    from avsr_tpu_torch.models.whisper_encoder import init_whisper_encoder
    from avsr_tpu_torch.train.state import path_leaves

    over = _over(**{"model.llm.tie_embeddings": "true"})
    mc = tcfg.load_config(None, over).model
    gen = torch.Generator().manual_seed(0)
    trees = {"hubert": chip_smoke.jitter(init_speech_ssl(gen, mc.ssl), gen),
             "llm": chip_smoke.jitter(init_llama(gen, mc.llm, torch.bfloat16), gen),
             "whisper": chip_smoke.jitter(init_whisper_encoder(gen, mc.whisper), gen),
             "clip": chip_smoke.jitter(init_clip_vit(gen, mc.clip), gen)}
    sizes = chip_smoke.write_hf_checkpoints(tmp_path, trees, mc)
    assert sizes.keys() == trees.keys() and all(v > 0 for v in sizes.values())
    assert len(list((tmp_path / "llm").glob("*.safetensors"))) == 2
    for name, cls, allowed in (("hubert", HubertModel, ()),
                               ("llm", LlamaForCausalLM, ("lm_head.weight",)),
                               ("whisper", WhisperForConditionalGeneration,
                                ("model.decoder.", "proj_out.")),
                               ("clip", CLIPVisionModel, ())):
        _, info = cls.from_pretrained(tmp_path / name, output_loading_info=True)
        assert info["unexpected_keys"] == [], (name, info["unexpected_keys"])
        assert all(k.startswith(allowed) for k in info["missing_keys"]), (name, info)

    for paths in ({"model.modality": "both", "model.whisper_path": tmp_path / "whisper",
                   "model.clip_path": tmp_path / "clip", "model.llm_path": tmp_path / "llm"},
                  {"model.modality": "audio", "model.audio_encoder": "hubert",
                   "model.audio_encoder_path": tmp_path / "hubert"}):
        o = over + [f"{k}={v}" for k, v in paths.items()]
        p_j, notes = jconvert.build_converted_params(jload_config(None, o))
        p_t, _ = tconvert.build_converted_params(tcfg.load_config(None, o), device="cpu")
        _compare(p_j, p_t, notes)
        got = path_leaves(p_t)
        for comp in notes:
            for k, v in path_leaves({comp: trees[comp]}).items():
                if k == "hubert/pos_conv/w":
                    torch.testing.assert_close(got[k], v, rtol=1e-5, atol=1e-7)
                else:
                    assert torch.equal(got[k], v.float()), k


def test_train_cli_starts_from_a_converted_export(hf_dirs, tmp_path):
    """``train --checkpoint EXPORT`` starts from the export's weights: with
    a zero learning rate the run's checkpoint holds them unchanged."""
    from avsr_tpu_torch.cli import train as tcli_train
    from avsr_tpu_torch.train.state import path_leaves

    paths = _paths(hf_dirs["safetensors"], "ssl")
    assert tconvert.main(["--device", "cpu", "--out", str(tmp_path / "exp"),
                          *_over(**paths)]) == 0
    dec = {k: v for k, v in paths.items() if not k.endswith("_path")}
    over = _over(**dec, **{"training.max_steps": 1, "training.learning_rate": 0.0,
                           "training.schedule": "constant", "training.save_every_steps": 0,
                           "training.checkpoint_dir": tmp_path / "run"})
    assert tcli_train.main(["--device", "cpu", *over, "--checkpoint",
                            str(tmp_path / "exp")]) == 0
    (step,) = [p for p in (tmp_path / "run" / "ckpt").iterdir() if p.name.isdigit()]
    got, want = path_leaves(load_params(step)), path_leaves(load_params(tmp_path / "exp"))
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k].float(), want[k]) for k in want)


def test_infer_and_stream_clis_read_a_converted_export(hf_dirs, tmp_path, capsys):
    """The one-utterance and streaming CLIs take ``--checkpoint`` of a
    converted HuBERT export: both print the transcript of
    ``generate_tokens`` over the same weights (f32; exact streaming commits
    nothing before its finalize here)."""
    from avsr_tpu_torch.cli import common as tcommon
    from avsr_tpu_torch.cli import infer as tcli_infer
    from avsr_tpu_torch.cli import stream as tcli_stream
    from avsr_tpu_torch.data.audio_io import load_audio, write_wav
    from avsr_tpu_torch.data.dataset import Sample
    from avsr_tpu_torch.data.loader import collate, featurize
    from avsr_tpu_torch.data.tokenizer import ByteTokenizer
    from avsr_tpu_torch.infer.generate import generate_tokens

    paths = _paths(hf_dirs["safetensors"], "ssl")
    assert tconvert.main(["--device", "cpu", "--out", str(tmp_path / "exp"),
                          *_over(**paths)]) == 0
    over = _over(**{k: v for k, v in paths.items() if not k.endswith("_path")})
    wav = tmp_path / "u.wav"
    write_wav(wav, (0.3 * np.random.default_rng(3).standard_normal(12_800)).astype(np.float32))

    cfg, tok = tcfg.load_config(None, over), ByteTokenizer()
    params = tcommon.load_decode_params(cfg, str(tmp_path / "exp"), seed=0, device="cpu")
    hb = collate([Sample("u", load_audio(wav), None, "", [tok.eos_id])], cfg.data,
                 tok.encode(cfg.model.prompt, add_bos=True), tok.pad_id)
    out = generate_tokens(params, cfg.model,
                          featurize(hb, "cpu", torch.float32, cfg.model),
                          max_new_tokens=cfg.decode.max_new_tokens, eos_id=tok.eos_id)
    ids = out.tokens[0, : int(out.lengths[0])].tolist()
    want = tok.decode(ids[:-1] if ids and ids[-1] == tok.eos_id else ids)

    capsys.readouterr()
    args = ["--device", "cpu", *over, "--checkpoint", str(tmp_path / "exp"), "--audio", str(wav)]
    assert tcli_infer.main(args) == 0
    assert capsys.readouterr().out.splitlines()[-1] == want
    assert tcli_stream.main([*args, "--chunk-s", "0.3", "--agree", "9"]) == 0
    assert capsys.readouterr().out.splitlines()[-1] == want


def test_chip_smoke_video_writer_key_map(tmp_path):
    """``chip_smoke.py``'s writers of the video encoders' published layouts
    (no ``transformers`` on the card's host): at a tiny width,
    ``from_pretrained`` loads the ResNet and EfficientNet directories with no
    missing and no unexpected key, the fairseq-layout oracle takes the
    AV-HuBERT state strictly but for the keys the converter skips, and the
    port's conversion of each gives the written tree back (the positional
    conv within f32 rounding)."""
    import chip_smoke
    from transformers import EfficientNetForImageClassification, ResNetForImageClassification

    from avsr_tpu_torch.train.state import path_leaves
    from test_avhubert_fairseq import _AVHubertOracle

    over = {**VIDEO["resnet"], **VIDEO["efficientnet"], **VIDEO["avhubert"],
            "model.efficientnet.hidden_dim": 1280}
    mc = tcfg.load_config(None, _over(**over)).model
    gen = torch.Generator().manual_seed(0)
    for enc, cls in (("resnet", ResNetForImageClassification),
                     ("efficientnet", EfficientNetForImageClassification), ("avhubert", None)):
        tree = chip_smoke.video_weights(enc, mc, gen)
        path = chip_smoke.write_video_checkpoint(tmp_path, enc, tree, mc)
        if cls is not None:
            _, info = cls.from_pretrained(path, output_loading_info=True)
            assert info["unexpected_keys"] == [] and info["missing_keys"] == [], (enc, info)
        else:
            sd = torch.load(path, weights_only=False,
                            pickle_module=tavh_pickle())["model"]
            oracle = _AVHubertOracle("concat", False)
            skipped = {"feature_extractor_audio.proj.weight", "final_proj.weight", "mask_emb"}
            missing, unexpected = oracle.load_state_dict(
                {k: v for k, v in sd.items() if k not in skipped}, strict=False)
            assert missing == [] and unexpected == [], (missing, unexpected)
        cfg = tcfg.load_config(None, _over(**over, **{"model.modality": "video",
                                                      "model.video_encoder": enc,
                                                      "model.video_encoder_path": path}))
        p_t, notes = tconvert.build_converted_params(cfg, device="cpu")
        assert notes == [enc]
        got, want = path_leaves(p_t[enc]), path_leaves(tree)
        assert got.keys() == want.keys()
        for k, v in want.items():
            if k == "pos_conv/w":
                torch.testing.assert_close(got[k], v, rtol=1e-5, atol=1e-7)
            else:
                assert torch.equal(got[k], v), (enc, k)


def tavh_pickle():
    from avsr_tpu_torch.models.avhubert import _PermissivePickle

    return _PermissivePickle
