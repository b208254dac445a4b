"""The port's reference-checkpoint converter (``cli/convert_ref_ckpt.py``)
against the JAX package's, on the same ``.pt`` (CPU).

The checkpoint is the JAX suite's: tiny HF Whisper, CLIP and a peft-wrapped
Llama (r = 2, trained-looking nonzero B) with simple connectors, saved as
the reference trainer saves it. Every leaf both packages convert must be
equal exactly, dtype included (LoRA ``a = Aᵀ``, ``b = Bᵀ``, connectors
``w = Wᵀ``); through the CLIs the exports are equal leaf for leaf and the
decode CLIs give the same hypotheses (f32, greedy). A connector type the
reference's weights do not fit, a rank mismatch and a foreign file are
handled as JAX handles them, where the port has the connector.
"""

import logging
import re

import jax
import numpy as np
import pytest
import torch

from avsr_tpu.cli import common as jcommon
from avsr_tpu.cli import convert_ref_ckpt as jref
from avsr_tpu.cli import decode as jcli_decode
from avsr_tpu.core.config import load_config as jload_config
from avsr_tpu_torch.cli import convert_ref_ckpt as tref
from avsr_tpu_torch.cli import decode as tcli_decode
from avsr_tpu_torch.core import config as tcfg
from avsr_tpu_torch.train.checkpoint import load_params

from test_ref_ckpt import D_AUDIO, D_VIDEO, _cfg, ref_ckpt  # noqa: F401 — the fixture
from test_torch_checkpoint_cli import hyp_lines
from test_torch_data import write_word_tokenizer
from test_torch_models import to_port_cfg
from test_torch_train import jax_paths, port_paths

torch.set_num_threads(1)


def _equal_trees(p_j, p_t, skip=()):
    got, want = port_paths(p_t), jax_paths(p_j)
    assert got.keys() == want.keys()
    for k, w in want.items():
        g, w = got[k], np.asarray(w)
        assert g.dtype == torch.float32 and w.dtype == np.float32, k
        assert tuple(g.shape) == w.shape, k
        if k[0] not in skip:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=str(k))


def test_payload_equals_jax(ref_ckpt):
    path, model = ref_ckpt
    p_j, notes_j = jref.build_ref_converted_params(_cfg(), str(path))
    p_t, notes_t = tref.build_ref_converted_params(to_port_cfg(_cfg(), tcfg.AVSRConfig),
                                                   str(path), device="cpu")
    assert notes_t == notes_j == ["whisper", "clip", "llm+lora(8)", "audio_connector",
                                  "video_connector"]
    _equal_trees(p_j, p_t)
    # the trained adapters are Aᵀ, Bᵀ of the peft modules, the connector Wᵀ
    q = model.llm.base_model.model.model.layers[1].self_attn.q_proj
    lora = p_t["llm"]["layers"][1]["q"]["lora"]
    assert torch.equal(lora["a"], q.lora_A["default"].weight.detach().T)
    assert torch.equal(lora["b"], q.lora_B["default"].weight.detach().T)
    assert torch.equal(p_t["video_connector"]["out"]["w"],
                       model.video_connector.linear.weight.detach().T)


def _overrides(dec_dir):
    over = {"model.modality": "both", "model.whisper.d_model": D_AUDIO,
            "model.whisper.n_heads": 2, "model.whisper.n_layers": 2,
            "model.whisper.max_frames": 100, "model.clip.image_size": 32,
            "model.clip.patch_size": 8, "model.clip.d_model": D_VIDEO,
            "model.clip.n_heads": 2, "model.clip.n_layers": 2,
            "model.llm.vocab_size": 128, "model.llm.d_model": 64, "model.llm.n_layers": 2,
            "model.llm.n_heads": 4, "model.llm.n_kv_heads": 2, "model.llm.ffn_dim": 128,
            "model.llm.rope_theta": 10000.0, "model.llm.tie_embeddings": "false",
            "model.llm.max_seq_len": 256, "model.lora.r": 2, "model.lora.alpha": 4,
            "model.lora.dropout": 0.0, "data.synthetic": "true", "data.synthetic_size": 8,
            "data.batch_size": 8, "data.max_label_length": 16, "data.audio_buckets": "[100]",
            "data.video_buckets": "[4]", "runtime.compute_dtype": "float32",
            "mesh.remat": "false", "decode.max_new_tokens": 6, "decode.batch_size": 8,
            "decode.output_dir": dec_dir}
    return [f"{k}={v}" for k, v in over.items()]


def test_cli_end_to_end_matches_jax(ref_ckpt, tmp_path):
    """convert_ref_ckpt --out, then decode --checkpoint, in each package:
    equal exports and the same hypotheses (an HF word tokenizer, whose ids
    fit the checkpoint's 128-id vocabulary)."""
    path, _ = ref_ckpt
    write_word_tokenizer(tmp_path / "tok")
    tok = [f"model.llm_path={tmp_path / 'tok'}"]
    jover, tover = _overrides(tmp_path / "jdec") + tok, _overrides(tmp_path / "tdec") + tok
    assert jref.main(["--checkpoint", str(path), "--out", str(tmp_path / "jexp"), *jover]) == 0
    assert tref.main(["--device", "cpu", "--checkpoint", str(path),
                      "--out", str(tmp_path / "texp"), *tover]) == 0
    jc = jload_config(None, jover)
    p_j = jax.tree_util.tree_map(np.asarray,
                                 jcommon.init_or_load_params(jc, str(tmp_path / "jexp")))
    _equal_trees(p_j, load_params(tmp_path / "texp"))
    assert jcli_decode.main(["--checkpoint", str(tmp_path / "jexp"), "--split", "train",
                             *jover]) == 0
    assert tcli_decode.main(["--device", "cpu", *tover, "--checkpoint",
                             str(tmp_path / "texp"), "--split", "train"]) == 0
    hyps = hyp_lines(tmp_path / "tdec")
    assert len(hyps) == 8 and hyps == hyp_lines(tmp_path / "jdec")


def test_nontransferable_connector(ref_ckpt, caplog):
    """JAX warns and keeps its fresh ``deep`` connectors; so does the port:
    the same notes, one "NOT transferable" warning per connector, and each
    connector equal to the port's fresh init from the same seed."""
    path, _ = ref_ckpt
    with caplog.at_level("WARNING", logger="avsr.cli.convert_ref"):
        _, notes_j = jref.build_ref_converted_params(_cfg("deep"), str(path))
    assert "audio_connector" not in notes_j
    assert any("NOT transferable" in r.message for r in caplog.records)
    caplog.clear()
    cfg = to_port_cfg(_cfg("deep"), tcfg.AVSRConfig)
    with caplog.at_level(logging.WARNING, logger="avsr_tpu_torch.cli.convert_ref"):
        p_t, notes = tref.build_ref_converted_params(cfg, str(path), device="cpu")
    assert notes == notes_j
    assert sum("NOT transferable" in r.message for r in caplog.records) == 2
    fresh = tref.init_avsr_model(cfg.model, seed=cfg.training.seed, device="cpu")
    for side in ("audio_connector", "video_connector"):
        for key in ("inp", "mid", "out", "res"):
            assert torch.equal(p_t[side][key]["w"], fresh[side][key]["w"]), (side, key)


def test_nontransferable_connector_warning_in_the_port(ref_ckpt, caplog, monkeypatch):
    """The port's warning branch, with a stand-in ``deep`` connector (the
    simple one's init and apply under the other name): the connectors stay
    at their init, as in JAX."""
    from avsr_tpu_torch.models import connectors

    path, _ = ref_ckpt
    monkeypatch.setitem(connectors._CONNECTORS, "deep", connectors._CONNECTORS["simple"])
    cfg = to_port_cfg(_cfg("deep"), tcfg.AVSRConfig)
    with caplog.at_level(logging.WARNING, logger="avsr_tpu_torch.cli.convert_ref"):
        p_t, notes = tref.build_ref_converted_params(cfg, str(path), device="cpu")
    assert notes == ["whisper", "clip", "llm+lora(8)"]
    assert sum("NOT transferable" in r.message for r in caplog.records) == 2
    fresh = tref.init_avsr_model(cfg.model, seed=cfg.training.seed, device="cpu")
    assert torch.equal(p_t["audio_connector"]["out"]["w"],
                       fresh["audio_connector"]["out"]["w"])


def test_rank_mismatch_rejected_as_jax(ref_ckpt):
    path, _ = ref_ckpt
    errs = []
    for build in (lambda c: jref.build_ref_converted_params(c, str(path)),
                  lambda c: tref.build_ref_converted_params(
                      to_port_cfg(c, tcfg.AVSRConfig), str(path), device="cpu")):
        cfg = _cfg()
        bad = type(cfg)(data=cfg.data, runtime=cfg.runtime, model=type(cfg.model)(
            modality="both", whisper=cfg.model.whisper, clip=cfg.model.clip,
            llm=cfg.model.llm, lora=type(cfg.model.lora)(use_lora=True, r=4, alpha=8)))
        with pytest.raises(ValueError, match=re.escape("LoRA rank 2")) as e:
            build(bad)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_foreign_file_rejected_as_jax(tmp_path):
    p = tmp_path / "other.pt"
    torch.save({"foo": torch.zeros(3)}, p)
    for build in (lambda: jref.build_ref_converted_params(_cfg(), str(p)),
                  lambda: tref.build_ref_converted_params(
                      to_port_cfg(_cfg(), tcfg.AVSRConfig), str(p), device="cpu")):
        with pytest.raises(ValueError, match="reference trainer checkpoint"):
            build()
