"""Whole runs of the harness on the CPU at a small size: the result line, the
traced metrics, the controls, and runs with the timed path broken underneath,
which have to come out not correct. The look for a card is skipped (the
runner is called with ``device="cpu"``); everything after it runs.

The card's own checks (``benchmark/run.py``, ``benchmark/readings.py``) are
marked ``cuda`` and skip here."""

import io
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark.harness import common, runner, spec

ROOT = Path(__file__).resolve().parents[2]
TINY = dict(embed_dim=64, image_resolution=32, vision_layers=2, vision_width=64,
            vision_patch_size=16, transformer_width=64, transformer_heads=2,
            transformer_layers=2)
SMALL = {
    "clip_vit_b16.generate": {"classes": [3, 5], "shots": 4, "pool_classes": 8},
    "clip_vit_l14_336.generate": {"classes": [3, 5], "shots": 4, "pool_classes": 8},
    "clip_vit_b16.train": {"classes": 4, "instances": 8, "image_side": 40},
}
CELLS = list(SMALL)


def overrides(cell, dtype="float32"):
    return {"config": {**TINY, "dtype": dtype}, "traffic": SMALL[cell]}


def run(cell, traced=False, seed=2**31 + 11, dtype="float32"):
    out, err = io.StringIO(), io.StringIO()
    result = runner.run(ROOT, cell, seed, 1.0, traced, device="cpu",
                        overrides=overrides(cell, dtype), out=out, err=err)
    line = out.getvalue().strip().splitlines()[-1]
    assert json.loads(line) == result
    return result, err.getvalue()


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_prints_the_result_line(cell):
    result, err = run(cell)
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert result["correct"] is True and result["attempted"] > 0 and result["failed"] == 0
    bench = spec.load_benchmark(ROOT)
    want = {m["name"] for m in spec.cell_metrics(bench, cell, "end_to_end")}
    assert set(result["metrics"]) == want
    assert all(m["value"] > 0 for m in result["metrics"].values())
    limits = spec.load_limits(ROOT, cell)["compared"]
    assert set(result["checks"]) == set(limits)
    # each number compared, beside its limit, ends standard error
    tail = err.strip().splitlines()[-len(limits):]
    assert [t.split()[1] for t in tail] == list(limits)


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reads_the_host_side_metrics(cell):
    result, _ = run(cell, traced=True)
    names = {m["name"] for m in spec.cell_metrics(spec.load_benchmark(ROOT), cell, "per_layer")}
    # the CPU has no device trace: only what the host and the counts give
    assert set(result["metrics"]) <= names
    assert result["device"]["window_s"] is not None
    if cell != "clip_vit_b16.train":
        assert any(name.startswith("prompt_us_per_class.") for name in result["metrics"])


# ``generate_from_features`` (cached exemplar features in), which no cell of
# BENCHMARK.json drives yet: the serving driver's second entry, as a cell
# would hold it
FEATURES = {"driver": "benchmark.harness.serve:Serve", "entry": "generate_from_features",
            "classes": [3, 6], "shots": 4, "pool_classes": 8, "exemplar_noise": 0.5,
            "eval_tau": 10.0}
FEATURE_LIMITS = {"sample_requests": 4, "tie_margin": 0.001,
                  "compared": {"cls_cos_max": 4e-4, "fusion_ref_mismatch": 0, "fusion_mismatch": 0}}


def make_cell(cell, seed, dtype):
    if cell == "features":
        cfg = {**spec.load_config(ROOT, "clip_vit_b16"), **TINY, "dtype": dtype}
        return common.Cell(root=ROOT, name=cell, config=cfg, traffic=FEATURES,
                           limits=FEATURE_LIMITS, seed=seed, device=torch.device("cpu"))
    return runner.make_cell(ROOT, cell, seed, "cpu", overrides(cell, dtype))


def readings(cell, variant, seed, dtype, with_info=False):
    driver = runner.make_driver(make_cell(cell, seed, dtype), variant)
    driver.warm()
    if cell != "clip_vit_b16.train":
        driver.window(0.3)
        driver.free()
    numbers, info = driver.check(driver.cell.limits)
    return (numbers, info) if with_info else numbers


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_features_entry_reads_within_its_limits(dtype):
    numbers = readings("features", None, 2**31 + 21, dtype)
    assert all(numbers[k] <= v for k, v in FEATURE_LIMITS["compared"].items()), numbers


@pytest.mark.parametrize("cell,variant", [("clip_vit_b16.generate", "int8"),
                                          ("features", "int8"),
                                          ("clip_vit_b16.train", "fp8")])
def test_the_control_reads_above_the_program(cell, variant):
    """The control (the program's int8 serving path; the reference in fp8 for
    training) against the bf16 program, at a size a test run holds."""
    compared = make_cell(cell, 5, "bfloat16").limits["compared"]
    sound = readings(cell, None, 5, "bfloat16")
    control = readings(cell, variant, 5, "bfloat16")
    assert any(control[k] > sound[k] for k in compared if k != "fusion_mismatch")


def _break_answer(monkeypatch):
    from ovmr_tpu_torch.models import ovmr

    real = ovmr.generate_classifiers_chunked

    def altered(*args, **kwargs):
        out = real(*args, **kwargs)
        out["mm_classifier"] = out["mm_classifier"].roll(1, dims=0)
        return out

    monkeypatch.setattr(ovmr, "generate_classifiers_chunked", altered)


def _break_fusion(monkeypatch):
    from ovmr_tpu_torch.models import ovmr

    real = ovmr.fusion_from_classifiers
    monkeypatch.setattr(ovmr, "fusion_from_classifiers",
                        lambda *a, **k: real(*a, **k).roll(1, dims=-1) * 0.5 + 0.25)


def _half_the_exemplars(monkeypatch):
    from ovmr_tpu_torch.models import ovmr

    real = ovmr.generate_vokens
    monkeypatch.setattr(ovmr, "generate_vokens",
                        lambda params, feats, *a, **k: real(params, feats[:, : feats.shape[1] // 2],
                                                            *a, **k))


def _state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def _half_the_batch(monkeypatch):
    from ovmr_tpu_torch.engine import train_step

    real = train_step._ce_pair

    def half(frozen, mm_cls, v_cls):
        q, e, pe, ve, labels, scale = frozen
        keep = labels < mm_cls.shape[0] // 2
        return real((q[keep], e, pe, ve, labels[keep], scale), mm_cls, v_cls)

    monkeypatch.setattr(train_step, "_ce_pair", half)


def _altered_loss(monkeypatch):
    from ovmr_tpu_torch.engine import train_step

    real = train_step.classifier_loss
    monkeypatch.setattr(train_step, "classifier_loss", lambda *a, **k: real(*a, **k) * 1.05)


FAULTS = [
    ("clip_vit_b16.generate", _break_answer),
    ("clip_vit_b16.generate", _break_fusion),
    ("clip_vit_b16.generate", _half_the_exemplars),
    ("clip_vit_l14_336.generate", _break_answer),
    ("clip_vit_b16.train", _state_unchanged),
    ("clip_vit_b16.train", _half_the_batch),
    ("clip_vit_b16.train", _altered_loss),
]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    result, err = run(cell)
    assert result["correct"] is False
    assert "FAILED" in err


@pytest.mark.parametrize("fault", [_break_answer, _break_fusion, _half_the_exemplars],
                         ids=lambda f: f.__name__[1:])
def test_a_broken_features_entry_reads_above_its_limits(fault, monkeypatch):
    fault(monkeypatch)
    numbers = readings("features", None, 2**31 + 11, "float32")
    assert any(numbers[k] > v for k, v in FEATURE_LIMITS["compared"].items()), numbers


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_on_the_card_a_short_run_is_correct(card, cell):
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                           str(2**31 + 99), "--seconds", "3", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"] is True


@pytest.mark.cuda
@pytest.mark.parametrize("cell,variant", [("clip_vit_b16.generate", "int8"),
                                          ("clip_vit_b16.train", "fp8")])
def test_on_the_card_the_control_fails(card, cell, variant):
    proc = subprocess.run([sys.executable, "benchmark/readings.py", "--workload", cell, "--seeds",
                           "301,302,303", "--variant", variant, "--seconds", "3"], cwd=ROOT,
                          capture_output=True, text=True, timeout=1800)
    assert proc.returncode == 0, proc.stderr[-2000:]
    limits = spec.load_limits(ROOT, cell)["compared"]
    for line in proc.stdout.strip().splitlines():
        row = json.loads(line)
        assert any(row[k] > v for k, v in limits.items())


def test_fusion_is_judged_against_the_reference_own_fusion(monkeypatch):
    """The reference's fusion on its own features and classifiers settles
    classes in a sound float32 run, and reads the altered weights on them."""
    for cell in ("clip_vit_b16.generate", "features"):
        numbers, info = readings(cell, None, 2**31 + 31, "float32", with_info=True)
        assert info["classes_settled_ref"] > 0 and numbers["fusion_ref_mismatch"] == 0
    _break_fusion(monkeypatch)
    for cell in ("clip_vit_b16.generate", "features"):
        assert readings(cell, None, 2**31 + 31, "float32")["fusion_ref_mismatch"] > 0
