"""The port's parity harness (``cli/parity.py``) and full-size converter
dry-runs, the counterparts of ``tests/test_parity_manifest.py`` and
``tests/test_parity_fullsize.py`` (CPU).

Tiny random ``transformers`` modules are written with ``save_pretrained``;
each of the port's modules, converted from the directory by the export
CLI's reader and converter, must match the HF module within the JAX
harness's ``TOLERANCES``. The manifest mode runs the decode protocol on
converted tiny checkpoints in both packages: with the port's fresh leaves
(the connector) set to JAX's, the HYP lines are equal (f32, greedy). The
full-size dry-runs instantiate the HF classes on the meta device and run
the port's converters over the meta tensors, at zero memory.
"""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from avsr_tpu.cli import convert_hf as jconvert
from avsr_tpu.cli import parity as jparity
from avsr_tpu.core.config import load_config as jload_config
from avsr_tpu_torch.cli import parity as tparity
from avsr_tpu_torch.cli import prepare_data as tprep
from avsr_tpu_torch.convert import from_numpy_tree
from avsr_tpu_torch.core.config import ClipConfig, LLMConfig, WhisperConfig
from avsr_tpu_torch.train.state import path_leaves

from gen_demo_hf_ckpts import build_tiny_hf_pair
from test_torch_checkpoint_cli import hyp_lines
from test_torch_convert_hf import MODEL, SSL_HF, VIDEO

torch.set_num_threads(1)

CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def hf_modules(tmp_path_factory):
    """{name: directory} of tiny random HF modules, one per parity check."""
    from transformers import (CLIPVisionConfig, CLIPVisionModel, EfficientNetConfig,
                              EfficientNetModel, HubertConfig, HubertModel, LlamaConfig,
                              LlamaForCausalLM, ResNetConfig, ResNetModel,
                              Wav2Vec2Config, Wav2Vec2Model, WhisperConfig as HFWhisper,
                              WhisperModel)

    def bn_stats(model):
        """Random BatchNorm statistics (init leaves them 0 and 1)."""
        g = torch.Generator().manual_seed(5)
        with torch.no_grad():
            for k, t in model.state_dict().items():
                if k.endswith("running_var"):
                    t.copy_(torch.rand(t.shape, generator=g) + 0.5)
                elif k.endswith("running_mean"):
                    t.copy_(0.1 * torch.randn(t.shape, generator=g))
        return model

    root = tmp_path_factory.mktemp("hf_modules")
    torch.manual_seed(0)
    models = {
        "whisper": WhisperModel(HFWhisper(
            num_mel_bins=80, d_model=32, encoder_layers=2, encoder_attention_heads=2,
            decoder_layers=1, decoder_attention_heads=2, encoder_ffn_dim=128,
            decoder_ffn_dim=128, max_source_positions=50, vocab_size=100, pad_token_id=0,
            bos_token_id=1, eos_token_id=2, decoder_start_token_id=1)),
        "hubert": HubertModel(HubertConfig(**SSL_HF)),
        "wav2vec2": Wav2Vec2Model(Wav2Vec2Config(**SSL_HF)),
        "clip": CLIPVisionModel(CLIPVisionConfig(
            hidden_size=24, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=96, image_size=16, patch_size=8)),
        "resnet": bn_stats(ResNetModel(ResNetConfig(
            num_channels=3, embedding_size=16, hidden_sizes=[32, 64], depths=[1, 2],
            layer_type="bottleneck"))),
        "efficientnet": bn_stats(EfficientNetModel(EfficientNetConfig(
            image_size=32, width_coefficient=1.0, depth_coefficient=1.0,
            in_channels=[32, 16], out_channels=[16, 24], kernel_sizes=[3, 5],
            strides=[1, 2], num_block_repeats=[1, 2], expand_ratios=[1, 6],
            depthwise_padding=[], hidden_dim=1280))),
        "llm": LlamaForCausalLM(LlamaConfig(
            vocab_size=260, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, intermediate_size=64, tie_word_embeddings=False,
            attention_bias=False, mlp_bias=False)),
    }
    for name, model in models.items():
        model.eval().save_pretrained(root / name)
    return {name: root / name for name in models}


# the config of each check: the modality and encoder that activate it, and
# the path key it reads
CHECKS = {
    "whisper": {"model.modality": "audio", "model.whisper_path": "whisper"},
    # the HF module reads the waveform as given (its processor normalizes),
    # as tests/test_models_hubert.py's configs do
    "hubert": {"model.modality": "audio", "model.audio_encoder": "hubert",
               "model.audio_encoder_path": "hubert", "model.ssl.normalize_input": "false"},
    "wav2vec2": {"model.modality": "audio", "model.audio_encoder": "wav2vec2",
                 "model.audio_encoder_path": "wav2vec2",
                 "model.ssl.normalize_input": "false"},
    "clip": {"model.modality": "video", "model.clip_path": "clip"},
    "resnet": {"model.modality": "video", "model.video_encoder": "resnet",
               "model.video_encoder_path": "resnet", **VIDEO["resnet"]},
    "efficientnet": {"model.modality": "video", "model.video_encoder": "efficientnet",
                     "model.video_encoder_path": "efficientnet", **VIDEO["efficientnet"]},
    # HF's tiny Llama defaults: rope_theta 1e4, rms_norm_eps 1e-6
    "llm": {"model.modality": "audio", "model.llm_path": "llm",
            "model.llm.tie_embeddings": "false", "model.llm.rope_theta": 10000.0,
            "model.llm.rms_eps": 1e-6},
}


def test_no_assets_returns_3(tmp_path, capsys):
    """Nothing configured: nothing checked, rc 3, no report."""
    assert tparity.main(CPU + ["--report", str(tmp_path / "r.json")]) == 3
    assert "no pretrained assets found" in capsys.readouterr().out
    assert not (tmp_path / "r.json").exists()


@pytest.mark.parametrize("name", list(CHECKS))
def test_module_check_passes(hf_modules, tmp_path, name):
    """Each per-module check, alone, passes within the JAX tolerance."""
    over = {**MODEL, **{k: hf_modules[v] if k.endswith("_path") else v
                        for k, v in CHECKS[name].items()}}
    report = tmp_path / "report.json"
    rc = tparity.main(CPU + ["--report", str(report)] + [f"{k}={v}" for k, v in over.items()])
    assert rc == 0
    rep = json.loads(report.read_text())
    assert list(rep["modules"]) == [name] and rep["all_pass"]
    entry = rep["modules"][name]
    assert entry["tol_max_abs"] == jparity.TOLERANCES[name] == tparity.TOLERANCES[name]
    assert entry["pass"] and entry["max_abs_err"] <= entry["tol_max_abs"]
    assert entry["ref_abs_mean"] > 0


def test_missing_transformers_names_the_package(hf_modules, tmp_path, monkeypatch):
    """On a host without ``transformers`` (the card's), a configured
    directory is an error naming the package, never rc 3 (a skip)."""
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers"):
        tparity.main(CPU + ["--report", str(tmp_path / "r.json"),
                            f"model.whisper_path={hf_modules['whisper']}",
                            *[f"{k}={v}" for k, v in MODEL.items()],
                            "model.modality=audio"])


MANIFEST = [
    "model.modality=audio", "model.whisper.d_model=64", "model.whisper.n_heads=2",
    "model.whisper.n_layers=2", "model.whisper.max_frames=100",
    "model.llm.vocab_size=260", "model.llm.d_model=64", "model.llm.n_layers=2",
    "model.llm.n_heads=4", "model.llm.n_kv_heads=2", "model.llm.ffn_dim=128",
    "model.llm.tie_embeddings=false", "model.llm.rope_theta=10000.0",
    "model.llm.max_seq_len=512", "model.lora.use_lora=false", "data.audio_buckets=[100]",
    "data.max_audio_length=16000", "data.max_label_length=24", "data.batch_size=2",
    "decode.max_new_tokens=4", "runtime.compute_dtype=float32"]


def test_parity_manifest_hyps_equal_jax(tmp_path, monkeypatch):
    """``--manifest`` on ``build_tiny_hf_pair``'s directories: the decode
    protocol runs over the test split in both packages, and with the port's
    fresh connector set to JAX's the HYP lines are equal."""
    root = tmp_path / "hf"
    build_tiny_hf_pair(root)
    data = tmp_path / "data"
    assert tprep.main(["--demo", "8", "--out", str(data), "--splits", "0.5,0.25,0.25",
                       "--seed", "3"]) == 0
    assert (data / "test.tsv").exists() and (data / "test.wrd").exists()
    over = [f"model.whisper_path={root / 'whisper'}", f"model.llm_path={root / 'llm'}",
            *MANIFEST]

    real = tparity.build_converted_params

    def with_jax_fresh_leaves(cfg, *, device="cuda"):
        params, notes = real(cfg, device=device)
        jparams, jnotes = jconvert.build_converted_params(jload_config(None, over))
        assert notes == jnotes == ["whisper", "llm"]
        for k in params:
            if k not in notes:
                params[k] = from_numpy_tree(jax.tree_util.tree_map(np.asarray, jparams[k]),
                                            device)
        return params, notes

    monkeypatch.setattr(tparity, "build_converted_params", with_jax_fresh_leaves)
    reports = {}
    for tag, run in (("jax", jparity.main), ("port", tparity.main)):
        report = tmp_path / f"{tag}.json"
        argv = ["--report", str(report), "--manifest", str(data), "--split", "test",
                *over, f"decode.output_dir={tmp_path / tag}"]
        assert run((CPU if tag == "port" else []) + argv) == 0
        reports[tag] = json.loads(report.read_text())
    rep = reports["port"]
    assert rep["all_pass"] and set(rep["modules"]) == {"whisper", "llm"}
    ev = rep["eval"]
    assert ev["split"] == "test" and ev["utterances"] == 2 and ev["wer"] >= 0.0
    assert set(ev) == set(reports["jax"]["eval"])
    body = (tmp_path / "port").glob("results_*.txt").__next__().read_text()
    assert body.count("UTT: ") == 2 and "REF: " in body and "HYP: " in body
    assert "WER: " in next((tmp_path / "port").glob("wer_*.txt")).read_text()
    hyps = hyp_lines(tmp_path / "port")
    assert len(hyps) == 2 and hyps == hyp_lines(tmp_path / "jax")


# ---------------------------------------------------------------------------
# Full-size converter dry-runs
# ---------------------------------------------------------------------------

def _meta_state(model) -> dict:
    return dict(model.state_dict())


def _shapes(tree) -> dict:
    return {k: tuple(v.shape) for k, v in path_leaves(tree).items()}


def _fresh(init, cfg) -> dict:
    with FakeTensorMode():
        return _shapes(init(torch.Generator(), cfg))


def test_fullsize_whisper_medium_converter_dryrun():
    from transformers import WhisperConfig as HFConfig
    from transformers import WhisperModel

    from avsr_tpu_torch.models.whisper_encoder import (convert_hf_whisper_encoder,
                                                       init_whisper_encoder)

    cfg = WhisperConfig()
    hf_cfg = HFConfig(
        num_mel_bins=cfg.n_mels, d_model=cfg.d_model,
        encoder_layers=cfg.n_layers, encoder_attention_heads=cfg.n_heads,
        encoder_ffn_dim=cfg.d_model * cfg.ffn_mult,
        decoder_layers=24, decoder_attention_heads=cfg.n_heads,
        decoder_ffn_dim=cfg.d_model * cfg.ffn_mult,
        max_source_positions=cfg.max_source_positions)
    with torch.device("meta"):
        model = WhisperModel(hf_cfg)
    converted = convert_hf_whisper_encoder(_meta_state(model), cfg)
    assert _shapes(converted) == _fresh(init_whisper_encoder, cfg)


def test_fullsize_clip_b32_converter_dryrun():
    from transformers import CLIPVisionConfig, CLIPVisionModel

    from avsr_tpu_torch.models.clip_vit import convert_hf_clip_vision, init_clip_vit

    cfg = ClipConfig()
    hf_cfg = CLIPVisionConfig(
        hidden_size=cfg.d_model, num_hidden_layers=cfg.n_layers,
        num_attention_heads=cfg.n_heads, intermediate_size=cfg.d_model * cfg.ffn_mult,
        image_size=cfg.image_size, patch_size=cfg.patch_size)
    with torch.device("meta"):
        model = CLIPVisionModel(hf_cfg)
    converted = convert_hf_clip_vision(_meta_state(model), cfg)
    assert _shapes(converted) == _fresh(init_clip_vit, cfg)


def test_fullsize_llama_32_1b_converter_dryrun():
    from transformers import LlamaConfig, LlamaForCausalLM

    from avsr_tpu_torch.models.llama import convert_hf_llama, init_llama

    cfg = LLMConfig()
    hf_cfg = LlamaConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.d_model,
        num_hidden_layers=cfg.n_layers, num_attention_heads=cfg.n_heads,
        num_key_value_heads=cfg.n_kv_heads, intermediate_size=cfg.ffn_dim,
        rope_theta=cfg.rope_theta, rms_norm_eps=cfg.rms_eps,
        tie_word_embeddings=cfg.tie_embeddings,
        max_position_embeddings=cfg.max_seq_len)
    with torch.device("meta"):
        model = LlamaForCausalLM(hf_cfg)
    sd = _meta_state(model)
    if cfg.tie_embeddings and "lm_head.weight" not in sd:    # as load_pretrained fills it
        sd["lm_head.weight"] = sd["model.embed_tokens.weight"]
    converted = convert_hf_llama(sd, cfg)
    shapes = _shapes(converted)
    assert shapes == _fresh(init_llama, cfg)
    # 1B-scale sanity: the converted tree really is llama-3.2-1B sized
    n_params = sum(int(np.prod(s)) for s in shapes.values())
    assert 1.2e9 < n_params < 1.4e9


def test_pretrained_parity_harness(tmp_path):
    """The armed end-to-end harness: real checkpoint directories at
    ``$AVSR_PRETRAINED/{whisper,clip,llm}`` go through the port's harness;
    skips until they exist."""
    root = os.environ.get("AVSR_PRETRAINED", "")
    if not root or not os.path.isdir(root):
        pytest.skip("set AVSR_PRETRAINED=/path with whisper/ clip/ llm/ "
                    "checkpoint dirs to run the pretrained parity harness")
    overrides = [f"{key}={os.path.join(root, name)}"
                 for name, key in (("whisper", "model.whisper_path"),
                                   ("clip", "model.clip_path"), ("llm", "model.llm_path"))
                 if os.path.isdir(os.path.join(root, name))]
    if not overrides:
        pytest.skip(f"no whisper/ clip/ llm/ checkpoint dirs under {root}")
    report = tmp_path / "parity_report.json"
    rc = tparity.main(CPU + ["--report", str(report)] + overrides)
    assert rc == 0, f"parity harness failed (rc={rc}) — see {report}"
