"""The port's entry points with checkpoints vs the JAX package's (f32, CPU):
train, average and decode ``--checkpoint``, and a quantized config loading
a full-precision checkpoint.

The JAX CLIs run on the tests' 8-device virtual CPU mesh (so batches of
8); the port's on the CPU. Greedy decoding is token-exact in f32, so the
two packages' HYP lines must be equal; averaged and quantized leaves are
compared exactly.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsr_tpu.cli import common as jcommon
from avsr_tpu.cli import decode as jcli_decode
from avsr_tpu.cli import train as jcli_train
from avsr_tpu.cli.average import average_params as javerage_params
from avsr_tpu.core.config import load_config as jload_config
from avsr_tpu.models import avsr as javsr
from avsr_tpu.train import checkpoint as jcheckpoint
from avsr_tpu.train import state as jstate
from avsr_tpu_torch.cli import average as tcli_average
from avsr_tpu_torch.cli import common as tcommon
from avsr_tpu_torch.cli import decode as tcli_decode
from avsr_tpu_torch.cli import train as tcli_train
from avsr_tpu_torch.convert import from_numpy_tree
from avsr_tpu_torch.core import config as tcfg
from avsr_tpu_torch.train import state as tstate
from avsr_tpu_torch.train.checkpoint import (CheckpointManager, export_params,
                                             load_params)

from test_torch_models import np_tree
from test_torch_train import jax_paths, port_paths

torch.set_num_threads(1)


def overrides(run_dir, dec_dir, **extra):
    over = {
        "data.synthetic": "true", "data.synthetic_size": 8,
        "data.batch_size": 8, "data.max_label_length": 24,
        "data.audio_buckets": "[100]", "data.video_buckets": "[4]",
        "model.modality": "audio",
        "model.whisper.d_model": 16, "model.whisper.n_heads": 2,
        "model.whisper.n_layers": 1, "model.whisper.max_frames": 100,
        "model.llm.vocab_size": 260, "model.llm.d_model": 32,
        "model.llm.n_layers": 1, "model.llm.n_heads": 2,
        "model.llm.n_kv_heads": 2, "model.llm.ffn_dim": 64,
        "model.llm.max_seq_len": 256, "model.lora.dropout": 0.0,
        "training.learning_rate": 1e-3, "training.warmup_steps": 1,
        "training.max_steps": 2, "training.save_every_steps": 0,
        "training.log_interval": 100, f"training.checkpoint_dir": str(run_dir),
        "mesh.remat": "false", "mesh.donate": "false",
        "runtime.compute_dtype": "float32", "decode.max_new_tokens": 6,
        "decode.batch_size": 8, "decode.output_dir": str(dec_dir)}
    over.update(extra)
    return [f"{k}={v}" for k, v in over.items()]


def hyp_lines(dec_dir):
    (results,) = dec_dir.glob("results_*.txt")
    return [ln for ln in results.read_text().splitlines() if ln.startswith("HYP:")]


def test_train_checkpoint_decode_matches_jax(tmp_path):
    """train 2 steps -> checkpoint -> decode --checkpoint, through each
    package's CLIs from the same initial weights: the same hypotheses."""
    jover = overrides(tmp_path / "jrun", tmp_path / "jdec")
    assert jcli_train.main(jover) == 0
    assert jcli_decode.main(["--checkpoint", str(tmp_path / "jrun" / "ckpt"),
                             "--split", "train", *jover]) == 0

    # the port starts from the JAX CLI's initial weights: a step-0
    # checkpoint in its run directory, from which its train CLI resumes
    tover = overrides(tmp_path / "trun", tmp_path / "tdec")
    jc, tc = jload_config(None, jover), tcfg.load_config(None, tover)
    init = np_tree(jstate.cast_frozen(
        javsr.init_avsr_model(jax.random.key(jc.training.seed), jc.model),
        jc.model, dtype=jnp.float32))
    st = tstate.create_train_state(from_numpy_tree(init, "cpu"), tc, 1)
    mngr = CheckpointManager(tmp_path / "trun" / "ckpt", tc)
    mngr.save(st)
    mngr.close()
    assert tcli_train.main(["--device", "cpu", *tover]) == 0
    # one batch per epoch: step 1 is also a best (val loss) save
    assert CheckpointManager(tmp_path / "trun" / "ckpt").all_steps() == [0, 1, 2]
    assert tcli_decode.main(["--device", "cpu", *tover, "--checkpoint",
                             str(tmp_path / "trun" / "ckpt"), "--split",
                             "train"]) == 0
    hyps = hyp_lines(tmp_path / "tdec")
    assert len(hyps) == 8 and hyps == hyp_lines(tmp_path / "jdec")
    for d in ("jdec", "tdec"):
        (w,) = (tmp_path / d).glob("wer_*.txt")
        assert re.search(r"WER: [0-9.]+", w.read_text())


def test_average_params_matches_jax():
    rng = np.random.default_rng(0)
    trees = [{"w": rng.standard_normal((3, 4)).astype(np.float32),
              "h": rng.standard_normal(5).astype(np.float32),
              "q": np.arange(6, dtype=np.int8)} for _ in range(3)]
    want = javerage_params([{"w": jnp.asarray(t["w"]),
                             "h": jnp.asarray(t["h"], jnp.bfloat16),
                             "q": jnp.asarray(t["q"])} for t in trees])
    got = tcli_average.average_params([{"w": torch.from_numpy(t["w"]),
                                        "h": torch.from_numpy(t["h"]).bfloat16(),
                                        "q": torch.from_numpy(t["q"])} for t in trees])
    assert got["h"].dtype == torch.bfloat16 and got["q"].dtype == torch.int8
    np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want["w"]))
    np.testing.assert_array_equal(got["h"].float().numpy(),
                                  np.asarray(want["h"], np.float32))
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    with pytest.raises(ValueError, match="do not average"):
        tcli_average.average_params([{"q": torch.arange(3)},
                                     {"q": torch.arange(3) + 1}])


def test_average_refuses_quantized(tmp_path):
    with pytest.raises(SystemExit, match="quantiz"):
        tcli_average.main(["--device", "cpu", "--checkpoint", str(tmp_path),
                           "--out", str(tmp_path / "o"), "model.use_4bit=true"])


def test_average_cli_end_to_end(tmp_path):
    """Train 3 steps with a checkpoint each, average the last 2: every leaf
    is the f32 mean of the two steps cast back; decode reads the export."""
    over = overrides(tmp_path / "run", tmp_path / "dec",
                     **{"training.max_steps": 3, "training.save_every_steps": 1})
    assert tcli_train.main(["--device", "cpu", *over]) == 0
    ck = tmp_path / "run" / "ckpt"
    assert tcli_average.main(["--device", "cpu", "--checkpoint", str(ck), "--last",
                              "2", "--out", str(tmp_path / "avg"), *over]) == 0
    srcs = [port_paths(load_params(ck / s)) for s in ("2", "3")]
    got = port_paths(load_params(tmp_path / "avg"))
    assert got.keys() == srcs[0].keys()
    moved = 0
    for k, v in got.items():
        want = ((srcs[0][k].float() + srcs[1][k].float()) / 2).to(srcs[0][k].dtype)
        assert v.dtype == srcs[0][k].dtype and torch.equal(v, want), k
        moved += not torch.equal(srcs[0][k], srcs[1][k])
    assert moved > 0
    assert tcli_decode.main(["--device", "cpu", *over, "--checkpoint",
                             str(tmp_path / "avg"), "--split", "train"]) == 0
    assert len(hyp_lines(tmp_path / "dec")) == 8


@pytest.mark.parametrize("quant", [["model.use_4bit=true"], ["model.use_8bit=true"]])
def test_quantized_config_loads_a_float_checkpoint_as_jax_does(tmp_path, quant):
    """A quantized config (with the serving preset's int8 head) reading a
    full-precision export restores the float tree, then quantizes it: the
    same serving leaves as the JAX package's ``load_decode_params``."""
    base = overrides(tmp_path / "run", tmp_path / "dec")
    jc = jload_config(None, base)
    rng = np.random.default_rng(1)
    weights = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.01 * rng.standard_normal(x.shape)).astype(np.float32),
        np_tree(javsr.init_avsr_model(jax.random.key(7), jc.model)))
    jcheckpoint.export_params(jax.tree_util.tree_map(jnp.asarray, weights),
                              tmp_path / "jexport")
    export_params(from_numpy_tree(weights, "cpu"), tmp_path / "texport")
    qover = base + quant + ["decode.lm_head_bits=8"]
    want = jax_paths(jcommon.load_decode_params(jload_config(None, qover),
                                                str(tmp_path / "jexport")))
    got = port_paths(tcommon.load_decode_params(
        tcfg.load_config(None, qover), str(tmp_path / "texport"), seed=3,
        device="cpu"))
    assert got.keys() == want.keys()
    assert any("qw" in k[-1] for k in got) and ("llm", "lm_head", "qw") in got
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]), err_msg=str(k))
    # a float config reading the same export gets the float leaves
    flt = port_paths(tcommon.init_or_load_params(tcfg.load_config(None, base),
                                                 str(tmp_path / "texport"),
                                                 seed=3, device="cpu"))
    for k, v in port_paths(from_numpy_tree(weights, "cpu")).items():
        assert torch.equal(flt[k], v), k
