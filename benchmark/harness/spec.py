"""What the benchmark runs, read from data.

``BENCHMARK.json`` at the root of the checkout names the cells; each cell's
configuration, traffic mix, per-layer metrics and comparison limits are files
of their own under ``benchmark/``, found by name:

- ``configs/<config>.json``: the model's sizes, dtype and source;
- ``traffic/<traffic>.json``: a mix's parameters, and under ``driver`` the
  class that runs it (``benchmark.<module>:<Class>``, a file under
  ``benchmark/``);
- ``end_to_end/<metric>.json``: what an end-to-end metric reads from the
  window (``reads``: ``rate`` of a ``count``, ``latency_ms`` at a
  ``quantile``, or ``setup_s``);
- ``metrics/<metric>.py``: one per-layer metric's reader;
- ``limits/<cell>.json``: the limits of the comparison that decides
  ``correct`` in that cell.

A cell, a configuration, a mix or a metric is added by adding files and
entries; no file here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
READS = {"rate": ("count",), "latency_ms": ("quantile",), "setup_s": ()}


class SpecError(ValueError):
    pass


def _load_json(path: Path) -> dict:
    if not path.is_file():
        raise SpecError(f"missing {path}")
    return json.loads(path.read_text())


def load_benchmark(root: Path = ROOT) -> dict:
    return _load_json(Path(root) / "BENCHMARK.json")


def bench_dir(root: Path) -> Path:
    return Path(root) / "benchmark"


def load_config(root: Path, name: str) -> dict:
    return _load_json(bench_dir(root) / "configs" / f"{name}.json")


def load_traffic(root: Path, name: str) -> dict:
    return _load_json(bench_dir(root) / "traffic" / f"{name}.json")


def load_limits(root: Path, cell: str) -> dict:
    return _load_json(bench_dir(root) / "limits" / f"{cell}.json")


def load_end_to_end(root: Path, name: str) -> dict:
    """What end-to-end metric ``name`` reads: ``{"reads": "rate", "count":
    <counted key>}``, ``{"reads": "latency_ms", "quantile": q}`` or
    ``{"reads": "setup_s"}``."""
    m = _load_json(bench_dir(root) / "end_to_end" / f"{name}.json")
    if m.get("reads") not in READS or set(m) != {"reads", *READS[m["reads"]]}:
        raise SpecError(f"end-to-end metric {name!r}: reads {m}")
    return m


def load_driver(root: Path, ref: str):
    """The driver class that ``ref`` (``benchmark.<module>:<Class>``) names:
    imported where ``root`` is this checkout, else loaded from the file under
    ``root``."""
    module, _, cls = str(ref).partition(":")
    if module.split(".")[0] != "benchmark" or not cls:
        raise SpecError(f"driver {ref!r} is not benchmark.<module>:<Class>")
    path = Path(root) / (module.replace(".", "/") + ".py")
    if not path.is_file():
        raise SpecError(f"driver {ref!r}: no file {path}")
    if Path(root).resolve() == ROOT:
        mod = importlib.import_module(module)
    else:
        spec = importlib.util.spec_from_file_location(f"benchmark_driver_{module}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    if not hasattr(mod, cls):
        raise SpecError(f"driver {ref!r}: {module} has no {cls}")
    return getattr(mod, cls)


def load_metric(root: Path, name: str):
    """The reader module of per-layer metric ``name``: it defines ``SPANS``
    (the program's functions it times) and ``read(ctx)``, which returns a
    number or None when there is nothing to read."""
    path = bench_dir(root) / "metrics" / f"{name}.py"
    if not path.is_file():
        raise SpecError(f"per-layer metric {name!r} has no reader metrics/{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` metrics that ``cell`` reports."""
    return [m for m in bench[kind] if "workloads" not in m or cell in m["workloads"]]


def find_cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SpecError(f"no workload {name!r} in BENCHMARK.json")


def validate(root: Path = ROOT) -> list:
    """Check BENCHMARK.json and every file it names; returns the cells'
    names, raises :class:`SpecError` on the first fault."""
    root = Path(root)
    bench = load_benchmark(root)
    names = set()

    def name_ok(value, what):
        if not isinstance(value, str) or not NAME.match(value):
            raise SpecError(f"{what} {value!r} is not a valid name")

    def unique(value, what):
        if value in names:
            raise SpecError(f"{what} {value!r} is not unique")
        names.add(value)

    configs = {}
    for c in bench["configs"]:
        name_ok(c["name"], "config")
        for key in c["reduced"]:
            name_ok(key, "reduced key")
        unique(("config", c["name"]), "config")
        if c["file"] != f"benchmark/configs/{c['name']}.json":
            raise SpecError(f"config {c['name']!r}: file should be "
                            f"benchmark/configs/{c['name']}.json")
        configs[c["name"]] = load_config(root, c["name"])
        if sorted(configs[c["name"]].get("reduced", [])) != sorted(c["reduced"]):
            raise SpecError(f"config {c['name']!r}: reduced differs from its file")
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            name_ok(m["name"], "metric")
            unique(("metric", m["name"]), "metric")
            if not UNIT.match(m["unit"]) or m["better"] not in ("lower", "higher"):
                raise SpecError(f"metric {m['name']!r}: unit or better")
            if m["source"] not in SOURCES:
                raise SpecError(f"metric {m['name']!r}: source {m['source']!r}")
            if kind == "end_to_end":
                load_end_to_end(root, m["name"])
    cells = []
    for w in bench["workloads"]:
        name_ok(w["name"], "workload")
        name_ok(w["config"], "config")
        name_ok(w["traffic"], "traffic")
        unique(("cell", w["name"]), "workload")
        unique(("pair", w["config"], w["traffic"]), "config and traffic pair")
        if w["config"] not in configs:
            raise SpecError(f"workload {w['name']!r}: unknown config {w['config']!r}")
        if w["chips"] not in (1, 4):
            raise SpecError(f"workload {w['name']!r}: chips")
        load_driver(root, load_traffic(root, w["traffic"]).get("driver"))
        load_limits(root, w["name"])
        e2e = cell_metrics(bench, w["name"], "end_to_end")
        per = cell_metrics(bench, w["name"], "per_layer")
        if "setup_s" not in {m["name"] for m in e2e} or len(e2e) < 2 or not per:
            raise SpecError(f"workload {w['name']!r}: needs setup_s, another end-to-end "
                            "metric and a per-layer metric")
        for m in per:
            if m["moves"] not in {x["name"] for x in e2e}:
                raise SpecError(f"metric {m['name']!r} moves {m['moves']!r}, which "
                                f"{w['name']!r} does not report")
            load_metric(root, m["name"])
        cells.append(w["name"])
    for m in bench["per_layer"] + bench["end_to_end"]:
        for cell in m.get("workloads", []):
            if cell not in cells:
                raise SpecError(f"metric {m['name']!r} lists unknown workload {cell!r}")
    return cells
