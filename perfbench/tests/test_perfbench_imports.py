"""Nothing the benchmark runs imports JAX or the JAX package; the reference
imports nothing of the program; the run refuses to measure without a card."""

import ast
import os
import subprocess
import sys

import pytest

from perfbench import core

FORBIDDEN = {"jax", "jaxlib", "flax", "tactilesr_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.ImportFrom):
            yield "." * node.level + (node.module or "")


SOURCES = sorted(p for p in core.PKG.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(core.PKG)))
def test_no_jax_by_whole_top_level_name(path):
    tops = {m.split(".")[0] for m in _imports(path) if m and not m.startswith(".")}
    assert not tops & FORBIDDEN


@pytest.mark.parametrize("path", sorted((core.PKG / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    for m in _imports(path):
        assert m.startswith(".") or m.split(".")[0] in {"torch", "math", "__future__"}, m


def test_reference_runs_with_the_program_and_jax_blocked(tmp_path):
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in {'tactilesr_torch', 'tactilesr_tpu', 'jax', 'jaxlib', 'flax'}:\n"
        "            raise ImportError(name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import perfbench.reference.model, perfbench.reference.lowp, perfbench.reference.compare\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=core.REPO, capture_output=True, text=True, timeout=120)
    assert r.stdout.strip() == "ok", r.stderr


def test_forbidden_names_compare_whole(monkeypatch):
    import importlib.util

    monkeypatch.setattr(sys, "path", list(sys.path))  # run.py puts the checkout's root first
    spec = importlib.util.spec_from_file_location("perfbench_run", core.PKG / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    fake = dict.fromkeys(["tactilesr_torch", "tactilesr_torch.serving", "jaxtyping", "flaxen"])
    monkeypatch.setattr(sys, "modules", {**fake})
    assert run.forbidden_modules() == []
    monkeypatch.setattr(sys, "modules", {**fake, "tactilesr_tpu.models": None, "jax": None})
    assert run.forbidden_modules() == ["jax", "tactilesr_tpu"]


def test_refuses_without_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "stsr-serve-bulk", "--seed", "1",
                        "--seconds", "1"], cwd=core.REPO, capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode != 0 and r.stdout == ""
