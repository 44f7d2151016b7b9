#!/usr/bin/env python3
"""The readings that set a cell's comparison limits, on the card.

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,3 \\
        [--variant int8|fp8|half_batch] [--seconds 4] [--classes 16,24]

For each seed, in one process: the cell's set-up, a short window at the
cell's own load (serving cells; training cells need none), and the comparison
with the plain reference, printed as one JSON line per seed. ``--variant``
puts the control in the program's place (``int8``: the program's own int8
serving path; ``fp8``: the reference computed with float8 operands, which
for a serving cell runs only until the sample of requests is full) or plants
a fault (``half_batch``: the loss over half of the classes). ``--classes``
replaces a serving mix's request sizes (a control that does not fit the
cell's own sizes). The benchmark's runs never run this.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / "benchmark_cache" / sub)
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variant", default=None)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--classes", default=None)
    args = ap.parse_args()
    import torch

    from benchmark.harness import runner

    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from ovmr_tpu_torch.ops import cuda_lib

    cuda_lib.build_all()
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        overrides = ({"traffic": {"classes": [int(c) for c in args.classes.split(",")]}}
                     if args.classes else None)
        cell = runner.make_cell(ROOT, args.workload, seed, "cuda", overrides)
        driver = runner.make_driver(cell, args.variant)
        driver.warm()
        row = {"workload": args.workload, "seed": seed, "variant": args.variant,
               "classes": cell.traffic.get("classes")}
        if hasattr(driver, "fill_sample"):  # serving: the sample comes from a window
            if args.variant == "fp8":
                driver.fill_sample()
            else:
                row["attempted"] = driver.window(args.seconds).attempted
            driver.free()
        numbers, info = driver.check(cell.limits)
        row.update(numbers)
        row.update(info)
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        del driver
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
