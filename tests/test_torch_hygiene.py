"""The port stands alone: no module of ``ovmr_tpu_torch`` and not
``chip_smoke.py`` imports JAX or anything of ``ovmr_tpu``, nothing imports
``triton`` or builds a kernel at import time, and every kernel source the
loader builds exists."""

import ast
import os
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "ovmr_tpu_torch"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_no_jax_and_nothing_of_ovmr_tpu():
    files = _port_files()
    assert len(files) > 20
    names = {str(f.relative_to(ROOT)) for f in files}
    for module in ("ops/block_fused_bwd.py", "engine/train_step.py", "engine/optimizers.py",
                   "engine/schedule.py", "engine/checkpoint.py", "ops/block_fused.py",
                   "ops/block_fused_tp.py", "parallel/mesh.py", "engine/trainer.py",
                   "ops/preprocess.py", "utils/config.py", "utils/defaults.py",
                   "utils/logger.py", "utils/meters.py", "utils/registry.py", "utils/tools.py",
                   "utils/tensorboard.py", "evaluation/evaluator.py", "data/datum.py",
                   "data/registry.py", "data/samplers.py", "data/transforms.py",
                   "data/prefetch.py", "data/manager.py", "data/datasets/common.py",
                   "data/datasets/fine_grained.py", "data/datasets/synthetic.py", "train.py"):
        assert f"ovmr_tpu_torch/{module}" in names, module
    bad = []
    for path in files:
        for name in _imports(ast.parse(path.read_text(), str(path))):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "flax", "optax", "ovmr_tpu"):
                bad.append(f"{path.relative_to(ROOT)}: {name}")
    assert not bad, bad


def test_no_module_level_triton_or_build():
    for path in _port_files():
        tree = ast.parse(path.read_text(), str(path))
        for node in tree.body:
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in node.names] + [getattr(node, "module", "") or ""]
                assert not any(n.split(".")[0] == "triton" for n in names), path
            if isinstance(node, ast.Expr) and isinstance(node.value, ast.Call):
                assert "build" not in ast.dump(node.value), path


def test_kernel_sources_present():
    from ovmr_tpu_torch.ops import cuda_lib

    for name in cuda_lib.SOURCES:
        assert (cuda_lib.CSRC / f"{name}.cu").is_file(), name
    assert sorted(p.stem for p in cuda_lib.CSRC.glob("*.cu")) == sorted(cuda_lib.SOURCES)
    assert sorted(cuda_lib._SIGNATURES) == sorted(cuda_lib.SOURCES)
    # every header a source includes is in the directory (and so in the hash)
    for src in cuda_lib.CSRC.glob("*.cu*"):
        for line in src.read_text().splitlines():
            if line.startswith('#include "'):
                assert (cuda_lib.CSRC / line.split('"')[1]).is_file(), (src.name, line)
    assert "sm_90a" in " ".join(cuda_lib.NVCC_FLAGS)
    # the build goes under build/, which .gitignore keeps out of commits
    assert cuda_lib.BUILD_DIR.relative_to(ROOT).parts[0] == "build"
    assert "build/" in (ROOT / ".gitignore").read_text().split()
    # every exported launcher the loader binds is defined in its source, and
    # every kernel wrapper has its launch count
    for name, signatures in cuda_lib._SIGNATURES.items():
        text = (cuda_lib.CSRC / f"{name}.cu").read_text()
        for fn in signatures:
            assert f"OVMR_EXPORT int {fn}(" in text, (name, fn)
    assert "fused_mlp_half_chunked" in cuda_lib.LAUNCHES
    assert os.path.isfile(PORT / "text" / "assets" / "bpe_simple_vocab_16e6.txt.gz")


def test_no_module_level_pil_or_yaml():
    """PIL and yaml are imported only inside the functions that need them,
    so the port imports where neither is installed."""
    for path in _port_files():
        tree = ast.parse(path.read_text(), str(path))
        for node in tree.body:
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in node.names] + [getattr(node, "module", "") or ""]
                assert not any(n.split(".")[0] in ("PIL", "yaml") for n in names), path
