"""The port is whole: every public module-level function and class of every
module of ``avsr_tpu`` has a counterpart in ``avsr_tpu_torch``.

A name's counterpart is the same name in the module of the same path under
``avsr_tpu_torch``, or the port name that ``RENAMED`` gives. ``EXCLUDED``
lists what has none, one reason each: JAX's registry, its runtime knobs,
and what only GSPMD's global arrays, XLA's sharding constraints or Orbax's
restore templates need (the JAX package's Orbax checkpoints reach the port
through ``tools/orbax_to_port.py``). Outside ``tests/``, that tool is the
one file that imports both JAX and the port.
"""

import importlib
import importlib.machinery
import inspect
import pkgutil
import re
from pathlib import Path

import pytest

import avsr_tpu

REPO = Path(__file__).resolve().parent.parent

# JAX name -> the port's "module:name" (the port names or places it otherwise)
RENAMED = {
    "avsr_tpu.models.layers:param_count": "avsr_tpu_torch.convert:param_count",
    "avsr_tpu.models.layers:cast_tree": "avsr_tpu_torch.convert:cast_tree",
    # the rule table per leaf; JAX maps it over the tree
    "avsr_tpu.mesh.sharding:param_specs": "avsr_tpu_torch.mesh.sharding:param_spec",
    # the optimizer is built over the sharded leaves, so its state follows
    "avsr_tpu.mesh.sharding:shard_state": "avsr_tpu_torch.mesh.sharding:shard_params",
    "avsr_tpu.mesh.sharding:shard_train_step": "avsr_tpu_torch.train.step:make_train_step",
    # the layers of a stage, run by hand instead of stacked for a scan
    "avsr_tpu.ops.pipeline:stack_stages": "avsr_tpu_torch.ops.pipeline:stage_layers",
    # the same function, kept once
    "avsr_tpu.data.video_io:sample_indices": "avsr_tpu_torch.ops.image:sample_frame_indices",
}

# JAX name (or module) -> why the port has no counterpart
EXCLUDED = {
    "avsr_tpu.core.registry": "the port keeps plain dicts (SCHEDULES, _CONNECTORS)",
    "avsr_tpu.core.runtime": "JAX and XLA knobs (prng_impl, the compilation cache); "
                             "debug_nans is in train/step.py",
    "avsr_tpu.native.libavsr_native": "the shared library itself, loaded with ctypes",
    "avsr_tpu.native:decode_wav": "no caller: the port's loader decodes through "
                                  "decode_wav_batch",
    "avsr_tpu.core.config:config_json": "no caller: the port writes to_dict's tree "
                                        "into its JSON files",
    "avsr_tpu.ops.logmel:num_mel_frames": "no caller: the port takes the frame count "
                                          "from the log-mel's shape",
    "avsr_tpu.mesh.multihost:put_global": "assembles a global jax.Array; a port rank "
                                          "keeps its rows (DataLoader(data_shard=))",
    "avsr_tpu.mesh.multihost:multihost_batch_sharder": "as put_global",
    "avsr_tpu.mesh.multihost:multihost_infer_batch_sharder": "as put_global",
    "avsr_tpu.mesh.sharding:batch_sharder": "device_put of a global batch under GSPMD",
    "avsr_tpu.mesh.sharding:infer_batch_sharder": "as batch_sharder",
    "avsr_tpu.ops.moe:constrain_ep": "an XLA sharding constraint; the port's expert "
                                     "exchange is explicit (scatter_to_experts)",
    "avsr_tpu.ops.qmatmul:set_force_xla": "turns Pallas off under GSPMD; the port's "
                                          "wrappers take use_kernel per call",
    "avsr_tpu.ops.quant:legacy_int4_template": "an Orbax restore template for old qw4 "
                                               "runs; tools/orbax_to_port.py restores "
                                               "them through it",
}


def _defined_in(obj, module: str) -> bool:
    """A function or class of ``module`` (a jitted or partial one too)."""
    for x in (obj, getattr(obj, "__wrapped__", None), getattr(obj, "func", None)):
        if (x is not None and getattr(x, "__module__", None) == module
                and (inspect.isfunction(x) or inspect.isclass(x))):
            return True
    return False


# The JAX package's compiled libraries, each by the source it is built from
# (at first use, beside the source: other tests build it, so whether the
# package walk would find the library depends on which ran first). The walk
# lists Python modules only; a library's entry is checked against its
# source.
LIBRARIES = {"avsr_tpu.native.libavsr_native": "avsr_tpu/native/avsr_native.cpp"}


def _jax_modules() -> list[str]:
    """The Python modules of ``avsr_tpu`` (no compiled library, built or
    not)."""
    return [m.name for m in pkgutil.walk_packages(avsr_tpu.__path__, "avsr_tpu.")
            if not isinstance(m.module_finder.find_spec(m.name).loader,
                              importlib.machinery.ExtensionFileLoader)]


def _public_names(module: str) -> list[str]:
    mod = importlib.import_module(module)
    return sorted(n for n, o in vars(mod).items()
                  if not n.startswith("_") and _defined_in(o, module))


def _counterpart(module: str, name: str):
    target = RENAMED.get(f"{module}:{name}", f"avsr_tpu_torch{module[8:]}:{name}")
    tmod, tname = target.split(":")
    try:
        return getattr(importlib.import_module(tmod), tname, None)
    except ImportError:
        return None


@pytest.mark.parametrize("module", [m for m in _jax_modules() if m not in EXCLUDED])
def test_every_public_name_has_a_counterpart(module):
    names = [n for n in _public_names(module) if f"{module}:{n}" not in EXCLUDED]
    missing = [n for n in names if _counterpart(module, n) is None]
    assert missing == [], f"{module}: no counterpart in the port for {missing}"


def test_exclusions_and_renames_are_current():
    """Every exclusion and rename names a JAX name that exists, and no
    excluded name has gained a counterpart."""
    modules = set(_jax_modules())
    for key in [*EXCLUDED, *RENAMED]:
        module, _, name = key.partition(":")
        if module in LIBRARIES:
            assert not name and (REPO / LIBRARIES[module]).is_file(), key
            continue
        assert module in modules, key
        if name:
            assert name in _public_names(module), key
    for key, target in RENAMED.items():
        assert _counterpart(*key.split(":")) is not None, target
    for key in EXCLUDED:
        module, _, name = key.partition(":")
        if name:
            assert _counterpart(module, name) is None, f"{key} now has a counterpart"


def test_only_the_converter_imports_both_packages():
    """Outside tests/, no Python file but tools/orbax_to_port.py imports
    JAX (or Orbax, or the JAX package) and the port together."""
    jax_import = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|orbax|optax|avsr_tpu)\b")
    port_import = re.compile(r"^\s*(import|from)\s+avsr_tpu_torch\b")
    both = []
    for f in sorted(REPO.rglob("*.py")):
        rel = f.relative_to(REPO)
        if rel.parts[0] in ("tests", "outputs") or rel.parts[0].startswith("."):
            continue
        lines = f.read_text(errors="replace").splitlines()
        if (any(jax_import.match(ln) for ln in lines)
                and any(port_import.match(ln) for ln in lines)):
            both.append(str(rel))
    assert both == ["tools/orbax_to_port.py"]
