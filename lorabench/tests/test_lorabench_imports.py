"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference and the traffic generator import nothing of the program.
Module names are compared by their whole top-level name: the port's
``gr_lora_tpu_torch`` begins with ``gr_lora_tpu``."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "gr_lora_tpu"}


def _top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _sources(*parts):
    return sorted(p for p in PKG.joinpath(*parts).rglob("*.py")
                  if "tests" not in p.parts)


def test_whole_names_are_compared():
    from lorabench.harness import forbidden_in

    assert forbidden_in(["gr_lora_tpu_torch", "gr_lora_tpu_torch.dist",
                         "numpy", "jaxtyping"]) == []
    assert forbidden_in(["gr_lora_tpu.models", "jax._src", "jaxlib",
                         "flax.linen"]) == ["flax", "gr_lora_tpu", "jax",
                                            "jaxlib"]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_jax_anywhere(path):
    assert not _top_level_imports(path) & JAX


@pytest.mark.parametrize("path", _sources("reference") + [
    PKG / "traffic" / "air.py", PKG / "stats.py"],
    ids=lambda p: p.name)
def test_reference_and_yardstick_import_nothing_of_the_program(path):
    assert not _top_level_imports(path) & (JAX | {"gr_lora_tpu_torch"})


def test_a_run_loads_no_jax():
    """Import every module a run imports, then look at sys.modules."""
    code = ("import lorabench.harness, lorabench.trace, lorabench.control;"
            "import lorabench.engines.triggered_fsm;"
            "import gr_lora_tpu_torch.dist.triggered;"
            "from lorabench.harness import loaded_forbidden;"
            "print(loaded_forbidden())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=PKG.parent, check=True)
    assert out.stdout.strip() == "[]"
