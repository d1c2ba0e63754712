"""The port stands alone: every tactilesr_torch module, and chip_smoke.py's
own imports, load in a process where jax, flax and tactilesr_tpu cannot be
imported."""

import os
import pkgutil
import subprocess
import sys

import tactilesr_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKER = """
import importlib.abc, sys
class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "tactilesr_tpu"):
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, _Block())
"""


def _modules():
    names = ["tactilesr_torch"]
    for info in pkgutil.walk_packages(tactilesr_torch.__path__, "tactilesr_torch."):
        names.append(info.name)
    return names


def _run(code):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    return subprocess.run([sys.executable, "-c", _BLOCKER + code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_nothing_of_jax():
    mods = _modules()
    assert "tactilesr_torch.ops.cuda" in mods and "tactilesr_torch.serving" in mods
    code = (
        "import importlib\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import sys\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'tactilesr_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = _run(code)
    assert proc.returncode == 0 and "ok" in proc.stdout, proc.stderr


def test_chip_smoke_imports_nothing_of_jax():
    """Importing chip_smoke.py runs none of its phases (they sit under its
    __main__ guard), so it loads here and must pull in no JAX."""
    code = (
        "import runpy, sys\n"
        "runpy.run_path('chip_smoke.py', run_name='chip_smoke_import_check')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'tactilesr_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = _run(code)
    assert proc.returncode == 0 and "ok" in proc.stdout, proc.stderr


def test_chip_smoke_fails_without_gpu():
    """Without CUDA the script exits non-zero and prints no result line."""
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the script would run its phases")
    proc = _run("import runpy; runpy.run_path('chip_smoke.py', run_name='__main__')")
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
