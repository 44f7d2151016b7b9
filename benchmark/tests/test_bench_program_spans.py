"""The per-layer metrics that read the program's own spans
(``benchmark/harness/program_spans.py`` over ``ovmr_tpu_torch.utils.trace``).

On the CPU a traced run reads the host-side ones (the tokenizer's stages,
the text tower's enqueue, the host's waits) as numbers and the stream-time
ones as null, since the CPU records no CUDA events; a program without the
recorder reads null everywhere and raises nothing. On the card (marked
``cuda``) a short traced run of each cell reads all of its metrics."""

import io
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark.harness import runner, spec

ROOT = Path(__file__).resolve().parents[2]
TINY = dict(embed_dim=64, image_resolution=32, vision_layers=2, vision_width=64,
            vision_patch_size=16, transformer_width=64, transformer_heads=2,
            transformer_layers=2)
SMALL = {
    "clip_vit_b16.generate": {"classes": [3, 5], "shots": 4, "pool_classes": 8},
    "clip_vit_l14_336.generate": {"classes": [3, 5], "shots": 4, "pool_classes": 8},
    "clip_vit_b16.train": {"classes": 4, "instances": 8, "image_side": 40},
}
HOST = {
    "clip_vit_b16.generate": ["text_tower_host_us_per_class.gen", "prompt_clean_us_per_class.gen",
                              "prompt_bpe_us_per_class.gen", "host_wait_us_per_request.gen"],
    "clip_vit_l14_336.generate": ["host_wait_us_per_request.l14"],
    "clip_vit_b16.train": [],
}
STREAM = {
    "clip_vit_b16.generate": ["text_tower_us_per_class.gen"],
    "clip_vit_l14_336.generate": ["text_tower_us_per_class.l14"],
    "clip_vit_b16.train": ["vision_us_per_image.train", "backward_us_per_image.train",
                           "optimizer_us_per_step.train"],
}
CELLS = list(SMALL)


def traced_run(cell):
    from ovmr_tpu_torch.utils import trace

    trace.reset()  # one process runs several cells here; the benchmark runs one
    out, err = io.StringIO(), io.StringIO()
    return runner.run(ROOT, cell, 2**31 + 41, 1.0, True, device="cpu",
                      overrides={"config": {**TINY, "dtype": "float32"}, "traffic": SMALL[cell]},
                      out=out, err=err)


def test_the_new_metrics_are_declared_for_their_cells():
    bench = spec.load_benchmark(ROOT)
    for cell in CELLS:
        names = {m["name"] for m in spec.cell_metrics(bench, cell, "per_layer")}
        assert set(HOST[cell] + STREAM[cell]) <= names, cell
    for m in bench["per_layer"]:
        if m["name"] in sum(HOST.values(), []) + sum(STREAM.values(), []):
            assert m["source"] == "program_span" and len(m["workloads"]) == 1
            assert not hasattr(spec.load_metric(ROOT, m["name"]), "SPANS")


@pytest.mark.parametrize("cell", CELLS)
def test_a_cpu_traced_run_reads_the_host_side_program_spans(cell):
    result = traced_run(cell)
    assert result["correct"] is True
    for name in HOST[cell]:
        assert result["metrics"][name]["value"] > 0, name
    for name in STREAM[cell]:
        assert name not in result["metrics"], name


@pytest.mark.parametrize("name", sum(HOST.values(), []) + sum(STREAM.values(), []))
def test_a_program_without_the_recorder_reads_null(name, monkeypatch):
    """The parent of the recorder's commit: importing it fails, and each
    reader gives None."""
    ctx = type("Ctx", (), {"counts": {"classes": 10, "requests": 2, "images": 8, "steps": 1}})()
    monkeypatch.setitem(sys.modules, "ovmr_tpu_torch.utils.trace", None)
    assert spec.load_metric(ROOT, name).read(ctx) is None


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_on_the_card_a_traced_run_reads_every_program_span(card, cell):
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                           str(2**31 + 97), "--seconds", "3", "--trace", "1"], cwd=ROOT,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-2000:]
    metrics = json.loads(proc.stdout.strip().splitlines()[-1])["metrics"]
    for name in HOST[cell] + STREAM[cell]:
        assert metrics[name]["value"] > 0, name
