#!/usr/bin/env python3
"""Readings behind ``chip_smoke.py`` phase 20's card-vs-CPU gates.

    python3 tools/probe_torch_dg_gates.py [--lr-cuts 1 0.1 0.03]

Writes phase 20's PACS-layout tree and, for each cut of the recipes'
learning rates, runs phase 20's gate check (``chip_smoke.dg_card_vs_cpu``)
for Vanilla, DDAIG, DAELDG, CrossGrad and DomainMix: two steps on the card
and on the CPU from one state and two batches, the card's two local data
shards (Vanilla), the controls (cuDNN's TF32 on; every gradient
``--grad-factor`` times its value; per-shard BatchNorm) and the card's drift under a 1e-6
input change, each as a share of its gate.
A check that fails prints its error and the probe goes on. Prints the
card's name and power limit first. Needs one card.
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


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--lr-cuts", type=float, nargs="+", default=[0.1])
    parser.add_argument("--grad-factor", type=float, default=1.2)
    args = parser.parse_args()
    import numpy as np
    import torch

    import chip_smoke as smoke

    if not torch.cuda.is_available():
        print("probe_torch_dg_gates: no CUDA device is available", file=sys.stderr)
        return 1
    print(f"[device] {smoke.nvidia_smi_line()}; torch {torch.__version__}", flush=True)
    smoke.DG_GRAD_FACTOR = args.grad_factor
    root = Path(tempfile.mkdtemp(prefix="ovmr_dg_gates_"))
    failed = 0
    try:
        smoke.write_pacs(np, root)
        for cut in args.lr_cuts:
            smoke.DG_GATE_LR = cut
            for tag in ("vanilla", "ddaig", "daeldg", "crossgrad", "domainmix"):
                t = time.perf_counter()
                print(f"[probe] lr cut {cut}, {tag}", flush=True)
                try:
                    smoke.dg_card_vs_cpu(torch, np, root, tag)
                except AssertionError:
                    failed += 1
                    traceback.print_exc(limit=0, file=sys.stdout)
                print(f"[probe] lr cut {cut}, {tag} in {time.perf_counter() - t:.1f} s",
                      flush=True)
                torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"[probe] {failed} checks failed", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
