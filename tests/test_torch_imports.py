"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, and its entry points run on the card unless told otherwise."""
import ast
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "src", "repro_torch")


def _modules():
    mods = []
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f),
                                      os.path.join(ROOT, "src"))
                mod = rel[:-3].replace(os.sep, ".")
                mods.append(mod[:-len(".__init__")]
                            if mod.endswith(".__init__") else mod)
    return sorted(mods)


MODULES = _modules()
SOURCES = sorted(os.path.relpath(os.path.join(d, f), ROOT)
                 for d, _, fs in os.walk(PKG) for f in fs
                 if f.endswith(".py")) + ["chip_smoke.py"]

_PROBE = r"""
import importlib, json, sys
sys.modules["jax"] = None          # any `import jax` now raises
sys.modules["jaxlib"] = None
out = {}
for name in json.loads(sys.argv[1]):
    try:
        importlib.import_module(name)
        err = None
    except Exception as e:            # reported per module
        err = f"{type(e).__name__}: {e}"
    leaked = sorted(m for m in sys.modules
                    if m == "repro" or m.startswith("repro."))
    out[name] = {"error": err, "leaked": leaked}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def imported():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", _PROBE, json.dumps(MODULES)],
                          capture_output=True, text=True, env=env,
                          timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", MODULES)
def test_module_imports_with_jax_blocked(imported, module):
    rec = imported[module]
    assert rec["error"] is None, rec["error"]
    assert rec["leaked"] == [], rec["leaked"]


def _imports(path):
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", SOURCES)
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == [], f"{path} imports {bad}"


def test_default_device_is_the_card():
    """On a machine without CUDA the default device raises instead of
    falling back to the CPU."""
    import torch
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import DecoderLM
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DecoderLM(smoke_config(get_config("llama3.2-1b"))).init()
