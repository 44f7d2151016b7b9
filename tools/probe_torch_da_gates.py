#!/usr/bin/env python3
"""Readings behind ``chip_smoke.py`` phase 21's card-vs-CPU gates.

    python3 tools/probe_torch_da_gates.py [--lr-cuts 1 0.1] [--tags dann cdac] [--runs]

Writes phase 21's Office-31 and Digit-5 trees, runs SourceOnly through the
entry point (ADDA and AdaBN start from its checkpoint) and, for each cut of
the recipes' learning rates (default: phase 21's cuts), phase 21's gate check
(``chip_smoke.da_card_vs_cpu``) for each DA trainer: two steps on the card
and on the CPU from one state and two pairs of batches, DANN's two local
data shards, the controls (cuDNN's TF32 on; every gradient
``--grad-factor`` times its value, or AdaBN's skipped statistics reset;
per-shard BatchNorm) and the card's drift under a 1e-6 input change, each as
a share of its gate; ``--random-start`` holds the ResNet-50 recipes from
their random init in place of the gates' zero-residual start. A check that
fails prints its error and the probe goes on. ``--runs`` then runs the
other ten entry-point runs of the phase. Prints the card's name and power
limit first. Needs one card.
"""

import argparse
import os
import shutil
import sys
import tempfile
import time
import traceback
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TAGS = ("source_only", "adda", "adabn", "dann", "mcd", "mme", "se", "m3sda", "dael", "cdac")


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--lr-cuts", type=float, nargs="+", default=None,
                        help="cuts of every recipe's lr (default: phase 21's own)")
    parser.add_argument("--grad-factor", type=float, default=1.2)
    parser.add_argument("--tags", nargs="+", default=list(TAGS), choices=TAGS)
    parser.add_argument("--runs", action="store_true")
    parser.add_argument("--random-start", action="store_true",
                        help="gate the ResNet-50 recipes from their random init")
    args = parser.parse_args()
    import numpy as np
    import torch

    import chip_smoke as smoke

    if not torch.cuda.is_available():
        print("probe_torch_da_gates: no CUDA device is available", file=sys.stderr)
        return 1
    print(f"[device] {smoke.nvidia_smi_line()}; torch {torch.__version__}", flush=True)
    smoke.DG_GRAD_FACTOR = args.grad_factor
    smoke.DA_GATE_ZERO_RESIDUAL = not args.random_start
    root = Path(tempfile.mkdtemp(prefix="ovmr_da_gates_"))
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True
    failed = 0
    try:
        smoke.write_da_trees(np, root)
        smoke.da_run(torch, np, root, "source_only")
        for cut in args.lr_cuts or [None]:
            if cut is not None:
                smoke.DG_GATE_LR, smoke.DA_GATE_LR_CUT = cut, {}
            for tag in args.tags:
                t = time.perf_counter()
                print(f"[probe] lr cut {cut}, {tag}", flush=True)
                try:
                    smoke.da_card_vs_cpu(torch, np, root, tag)
                except AssertionError:
                    failed += 1
                    traceback.print_exc(limit=0, file=sys.stdout)
                print(f"[probe] lr cut {cut}, {tag} in {time.perf_counter() - t:.1f} s",
                      flush=True)
                torch.cuda.empty_cache()
        if args.runs:
            for tag in smoke.DA_RUNS:
                if tag != "source_only":
                    try:
                        smoke.da_run(torch, np, root, tag)
                    except AssertionError:
                        failed += 1
                        traceback.print_exc(limit=0, file=sys.stdout)
                    torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
        shutil.rmtree(root, ignore_errors=True)
    print(f"[probe] {failed} checks failed", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
