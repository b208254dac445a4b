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
    assert res["bad"] == []


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
