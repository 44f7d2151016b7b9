"""BENCHMARK.json keeps to the benchmark's rules, and a cell is added by
adding files and entries only."""

import hashlib
import io
import json
import re
import shutil
from pathlib import Path

import pytest

from benchmark.harness import runner, spec

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
FILE = re.compile(r"^[A-Za-z0-9_.\-/]+$")


def test_benchmark_json_keeps_the_rules():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["benchmark"] and 1 <= b["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w for w in b["command"])
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
    for group, allowed in keys.items():
        for entry in b[group]:
            extra = {"workloads"} if group in ("end_to_end", "per_layer") else set()
            assert allowed <= set(entry) <= allowed | extra, (group, entry["name"])
            assert NAME.match(entry["name"]), entry["name"]
            for text_key in ("why", "layer", "source"):
                if text_key in entry:
                    text = entry[text_key]
                    assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for w in b["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
    for c in b["configs"]:
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    for path in (ROOT / "benchmark").rglob("*"):
        if "__pycache__" not in path.parts and path.is_file():
            assert FILE.match(str(path.relative_to(ROOT))), path
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_cell_validates():
    cells = spec.validate(ROOT)
    assert cells == [w["name"] for w in spec.load_benchmark(ROOT)["workloads"]]


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


FIXED_ORDER = """from benchmark.harness.serve import Serve


class FixedOrder(Serve):
    \"\"\"The mix's sizes in the listed order, every pass.\"\"\"

    def plan(self):
        while True:
            for n in self.sizes:
                yield n, 0, self.names[:n]
"""


def test_a_cell_is_added_by_files_and_entries_alone(tmp_path):
    """A configuration, a traffic mix with a driver of its own, an end-to-end
    rate and a per-layer metric, each a new file; the new cell validates and
    runs on the CPU with no file of the benchmark edited."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = _digest(tmp_path / "benchmark")
    bench = tmp_path / "benchmark"
    cfg = json.loads((bench / "configs" / "clip_vit_b16.json").read_text())
    cfg.update(vision_patch_size=32)
    (bench / "configs" / "clip_vit_b32.json").write_text(json.dumps(cfg))
    (bench / "harness" / "fixed_order.py").write_text(FIXED_ORDER)
    (bench / "traffic" / "generate_small.json").write_text(json.dumps(
        {"driver": "benchmark.harness.fixed_order:FixedOrder", "entry": "generate",
         "classes": [8, 16], "shots": 4, "pool_classes": 32, "exemplar_noise": 0.5,
         "eval_tau": 10.0}))
    (bench / "end_to_end" / "requests_per_s.json").write_text(
        json.dumps({"reads": "rate", "count": "requests"}))
    (bench / "metrics" / "requests_per_s.gen.py").write_text(
        "def read(ctx):\n    return ctx.counts.get('requests', 0) / ctx.window_s\n")
    (bench / "limits" / "clip_vit_b32.generate_small.json").write_text(json.dumps(
        {"sample_requests": 2, "tie_margin": 0.001,
         "compared": {"cls_cos_max": 0.05, "fusion_mismatch": 0}}))
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "clip_vit_b32", "source": "https://github.com/openai/CLIP",
                         "file": "benchmark/configs/clip_vit_b32.json", "reduced": [],
                         "why": "a test"})
    b["workloads"].append({"name": "clip_vit_b32.generate_small", "config": "clip_vit_b32",
                           "traffic": "generate_small", "chips": 1, "why": "a test"})
    b["end_to_end"].append({"name": "requests_per_s", "unit": "requests/s", "better": "higher",
                            "bound": 0.05, "source": "host_clock",
                            "workloads": ["clip_vit_b32.generate_small"]})
    b["per_layer"].append({"name": "requests_per_s.gen", "unit": "requests/s",
                           "better": "higher", "source": "host_clock", "layer": "a test",
                           "moves": "requests_per_s",
                           "workloads": ["clip_vit_b32.generate_small"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    cells = spec.validate(tmp_path)
    assert "clip_vit_b32.generate_small" in cells
    after = _digest(bench)
    assert {k: v for k, v in after.items() if k in before} == before
    tiny = dict(embed_dim=64, image_resolution=32, vision_layers=2, vision_width=64,
                vision_patch_size=16, transformer_width=64, transformer_heads=2,
                transformer_layers=2, dtype="float32")
    out = io.StringIO()
    for traced in (False, True):
        result = runner.run(tmp_path, "clip_vit_b32.generate_small", 2**31 + 5, 0.3, traced,
                            device="cpu", overrides={"config": tiny}, out=out,
                            err=io.StringIO())
        assert result["correct"] is True
        want = {"requests_per_s.gen"} if traced else {"requests_per_s", "setup_s"}
        assert set(result["metrics"]) == want
        assert result["metrics"]["requests_per_s" + (".gen" if traced else "")]["value"] > 0


@pytest.mark.parametrize("fault", ["unknown config", "metric without reader", "bad unit",
                                   "end-to-end metric without file", "driver outside"])
def test_validation_refuses_a_broken_file(tmp_path, fault):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    if fault == "unknown config":
        b["workloads"][0]["config"] = "no_such_config"
    elif fault == "metric without reader":
        b["per_layer"][0]["name"] = "no_reader.gen"
    elif fault == "bad unit":
        b["end_to_end"][0]["unit"] = "classes per second"
    elif fault == "end-to-end metric without file":
        b["end_to_end"][0]["name"] = "no_file_per_s"
    else:
        path = tmp_path / "benchmark" / "traffic" / f"{b['workloads'][0]['traffic']}.json"
        traffic = json.loads(path.read_text())
        traffic["driver"] = "ovmr_tpu_torch.api:OVMRGenerator"
        path.write_text(json.dumps(traffic))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    with pytest.raises(spec.SpecError):
        spec.validate(tmp_path)
