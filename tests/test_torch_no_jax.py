"""The port stands alone: every tactilesr_torch module (the SR recipe and
its two entries among them), chip_smoke.py's own imports and the stage-1
training entry load and run in a process where jax, flax, optax,
ml_dtypes and tactilesr_tpu cannot be imported."""

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
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "ml_dtypes", "tactilesr_tpu"):
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
    for m in ("ops.cuda", "serving", "server", "tasks.tpsf_task", "tasks.sr_task",
              "tasks.sr_seqs_task", "__main__", "bench", "graft_entry",
              "compat.torch_convert", "compat.export_torch", "runtime.device"):
        assert f"tactilesr_torch.{m}" in mods, m
    code = (
        "import importlib\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import sys\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax', 'tactilesr_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = _run(code)
    assert proc.returncode == 0 and "ok" in proc.stdout, proc.stderr


def test_port_module_list_covers_the_training_runtime():
    """The modules of the runtime (scan_epochs, remat, ProfilerHook and the
    tracer among them), of TactileSRCNN and of generation (the native
    preprocessing among them) are in the list the import check walks."""
    mods = set(_modules())
    for m in ("config.default", "config.parser", "data.loader", "metrics", "parallel.dist",
              "parallel.mesh",
              "runtime.checkpoint", "runtime.history", "runtime.hooks.builtin",
              "runtime.hooks.hookbase", "runtime.hooks.profiler", "runtime.logger", "runtime.misc",
              "runtime.optim", "runtime.schedule", "runtime.tracing", "runtime.trainer", "tasks.tpsf_task",
              "ops.graph",
              "models.blocks", "models.tactile_sr", "models.inference", "compat.from_jax",
              "native", "data.raw_process", "data.generate", "ops.cuda.probe"):
        assert f"tactilesr_torch.{m}" in mods, m


def test_tpsf_training_entry_runs_without_jax(tmp_path):
    """``python -m tactilesr_torch.tasks.tpsf_task`` trains one epoch on
    the CPU at toy size with JAX blocked, and writes its checkpoints."""
    raw, work = str(tmp_path / "raw"), str(tmp_path / "work")
    code = (
        "import runpy, sys\n"
        "from tactilesr_torch.data import generate\n"
        f"generate._cli(['synthetic', '--out-dir', {raw!r}, '--names', 'C', '--taps-per-blob', '9',"
        " '--seqs', '24'])\n"
        f"sys.argv = ['tpsf_task', '--device', 'cpu', '--dataset_dir', {raw!r}, '--save_dir',"
        f" {work!r}, '--epochs', '1', '--sample_cnt', '4', '--train_batch_size', '8',"
        " '--inference_test', 'false']\n"
        "runpy.run_module('tactilesr_torch.tasks.tpsf_task', run_name='__main__')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax', 'tactilesr_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = _run(code)
    assert proc.returncode == 0 and "ok" in proc.stdout, proc.stderr
    assert sorted(os.listdir(os.path.join(work, "checkpoints"))) == ["epoch_0.pth", "latest.pth"]


def test_chip_smoke_imports_nothing_of_jax():
    """Importing chip_smoke.py runs none of its phases (they sit under its
    __main__ guard), so it loads here and must pull in no JAX."""
    code = (
        "import runpy, sys\n"
        "runpy.run_path('chip_smoke.py', run_name='chip_smoke_import_check')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax', 'tactilesr_tpu')]\n"
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
