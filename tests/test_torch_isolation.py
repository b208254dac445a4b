"""The PyTorch port stands alone: importing every module of avsr_tpu_torch
(and chip_smoke.py) loads neither JAX nor anything of the JAX package."""

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, json, pkgutil, sys
import avsr_tpu_torch
names = ["avsr_tpu_torch"] + [m.name for m in pkgutil.walk_packages(
    avsr_tpu_torch.__path__, "avsr_tpu_torch.")]
for n in names:
    importlib.import_module(n)
importlib.import_module("chip_smoke")
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "avsr_tpu", "flax", "optax",
                                    "orbax"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert "avsr_tpu_torch.infer.generate" in res["modules"]
    assert "avsr_tpu_torch.cli.decode" in res["modules"]
    assert "avsr_tpu_torch.train.checkpoint" in res["modules"]
    for name in ("infer.engine", "infer.adapters", "infer.server", "infer.streaming",
                 "cli.serve", "cli.stream", "cli.infer", "data.audio_io", "data.video_io",
                 "data.manifest", "native", "cli.prepare_data", "models.hubert",
                 "core.hf_files", "cli.convert_hf", "cli.convert_ref_ckpt", "cli.validate",
                 "cli.analyze_memory", "cli.profile", "cli.parity"):
        assert f"avsr_tpu_torch.{name}" in res["modules"], name
    assert res["bad"] == []


def test_tokenizer_module_imports_no_tokenizers():
    """The HF tokenizer's library is imported when one is built, so the
    package imports on a host without it."""
    probe = ("import sys, avsr_tpu_torch.data.tokenizer as t, avsr_tpu_torch.cli.common; "
             "print('tokenizers' in sys.modules, type(t.load_tokenizer(None)).__name__)")
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "ByteTokenizer"]


def test_port_sources_name_no_jax():
    """No source file of the port imports jax or avsr_tpu (static check,
    covering modules a run might only import lazily)."""
    files = sorted((REPO / "avsr_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    for f in files:
        for line in f.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                mod = s.split()[1].split(".")[0]
                assert mod not in ("jax", "jaxlib", "avsr_tpu", "orbax"), f"{f}: {s}"


def test_converters_need_no_transformers(tmp_path):
    """The converters read an HF directory with neither ``transformers``
    nor ``safetensors`` (nor ``tokenizers``) imported: a safetensors file
    written by ``chip_smoke.py``'s writer goes through ``load_pretrained``
    in a process that has loaded only the port."""
    probe = (
        "import sys, torch, chip_smoke\n"
        "import avsr_tpu_torch.cli.convert_hf, avsr_tpu_torch.cli.convert_ref_ckpt\n"
        "from avsr_tpu_torch.core.hf_files import load_pretrained\n"
        f"d = {str(tmp_path)!r}\n"
        "chip_smoke.write_safetensors(__import__('pathlib').Path(d) / 'model.safetensors',\n"
        "    {'w': torch.arange(6, dtype=torch.bfloat16).reshape(2, 3)})\n"
        "open(d + '/config.json', 'w').write('{}')\n"
        "sd, _ = load_pretrained(d)\n"
        "assert sd['w'].dtype == torch.float32 and sd['w'].tolist() == [[0, 1, 2], [3, 4, 5]]\n"
        "print(sorted(m for m in ('transformers', 'safetensors', 'tokenizers', 'peft')\n"
        "             if m in sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
    for f in ("cli/convert_hf.py", "cli/convert_ref_ckpt.py", "core/hf_files.py",
              "models/hubert.py"):
        for line in (REPO / "avsr_tpu_torch" / f).read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                assert s.split()[1].split(".")[0] not in (
                    "transformers", "safetensors", "peft", "tokenizers"), f"{f}: {s}"
