"""Nothing the benchmark runs imports JAX or the JAX package, and the plain
reference imports nothing of the program. Import names are compared by their
top-level name, whole: ``ovmr_tpu_torch`` is not ``ovmr_tpu``."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
NEVER = {"jax", "jaxlib", "flax", "optax", "ovmr_tpu"}
NOT_IN_REFERENCE = NEVER | {"ovmr_tpu_torch"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant):
                names.add(str(arg.value).split(".")[0])
    return names


FILES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & NEVER


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert not names & NOT_IN_REFERENCE
    # the reference stands alone: the standard library, torch, numpy, itself
    assert "benchmark" not in names


def test_span_targets_name_the_port_only():
    for path in sorted((BENCH / "metrics").glob("*.py")):
        for line in path.read_text().splitlines():
            if '": "ovmr' in line:
                module = line.split('": "', 1)[1].split(":", 1)[0]
                assert module.split(".")[0] == "ovmr_tpu_torch", path.name


def test_the_run_check_compares_whole_top_level_names():
    from benchmark.harness import runner

    assert runner.loaded_forbidden(["ovmr_tpu_torch", "ovmr_tpu_torch.api", "torch"]) == []
    assert runner.loaded_forbidden(["ovmr_tpu.models.clip", "jaxlib.xla_client", "flax"]) == [
        "flax", "jaxlib", "ovmr_tpu"]


@pytest.mark.parametrize("path", sorted((BENCH / "traffic").glob("*.json")), ids=lambda p: p.name)
def test_each_driver_is_a_file_of_the_benchmark(path):
    import json

    module = json.loads(path.read_text())["driver"].split(":")[0]
    assert module.split(".")[0] == "benchmark"
    assert (BENCH.parent / (module.replace(".", "/") + ".py")).is_file()
