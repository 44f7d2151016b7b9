#!/usr/bin/env python3
"""The benchmark of ``ovmr_tpu_torch`` on one NVIDIA card: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cells are listed in ``BENCHMARK.json``.
The run builds (or loads) the program's kernels into ``build/`` of the
checkout, makes the weights and the traffic on the card from ``--seed``, warms
every shape of the cell, measures ``--seconds`` of closed-loop work, checks
the window's outputs against the plain reference under ``benchmark/reference``
and prints one JSON line last. Without a card it prints no result and exits
with 3.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache inside the checkout, at fixed paths
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / "benchmark_cache" / sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    import torch

    from benchmark.harness import runner, spec

    cell = spec.find_cell(spec.load_benchmark(ROOT), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 3
    torch.set_num_threads(4)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = runner.run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                        t_process=T_PROCESS)
    return 0 if result is not None else 4


if __name__ == "__main__":
    sys.exit(main())
