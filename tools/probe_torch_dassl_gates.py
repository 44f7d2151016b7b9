#!/usr/bin/env python3
"""Readings behind ``chip_smoke.py``'s card-vs-CPU gates of the Dassl
trainers: phase 20 (``dg``, PACS), 21 (``da``, Office-31 and Digit-5) and 22
(``ssl``, CIFAR-10).

    python3 tools/probe_torch_dassl_gates.py --phase {dg,da,ssl}
        [--lr-cuts 0.1 0.01] [--tags ...] [--grad-factor 1.2] [--runs]
        [--random-start] [--lpclip] [--orders N]

Writes the phase's tree (``da``: then runs SourceOnly through the entry
point, as ADDA and AdaBN start from its checkpoint) and, for each cut of the
recipes' learning rate (default: the phase's own cuts), the phase's gate
check for each trainer: two steps on the card and on the CPU from one state
and the same batches, the two local data shards (Vanilla, DANN, FixMatch),
the controls (cuDNN's TF32 on; every gradient ``--grad-factor`` times its
value, or AdaBN's skipped statistics reset; per-shard BatchNorm) and the
card's drift under a 1e-6 input change, each as a share of its gate. A
check that fails prints its error and the probe goes on. ``--runs`` then
runs the phase's other entry-point runs; ``--random-start`` (``da``) holds
the ResNet-50 recipes from their random init in place of the gates'
zero-residual start; ``--lpclip`` (``ssl``) runs phase 22's lpclip part;
``--orders N`` (``da``, ``ssl``) repeats the gate checks under N listing
orders of the trees' image folders (the loaders keep a folder's order unsorted, as the
reference does, so each filesystem hands the gates other batches): order k
lists each folder's sorted names shuffled from seed k.
Prints the card's name and power limit first. Needs one card.
"""

import argparse
import contextlib
import os
import random
import shutil
import sys
import tempfile
import time
import traceback
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _dg_cut(smoke, cut):
    smoke.DG_GATE_LR = cut


def _da_cut(smoke, cut):
    smoke.DG_GATE_LR, smoke.DA_GATE_LR_CUT = cut, {}


def _ssl_cut(smoke, cut):
    smoke.SSL_GATE_LR = cut


# each phase's tree writer, gate check, gated trainers, setter of one cut of
# every recipe's lr, entry-point runner and its runs (``chip_smoke`` names)
PHASES = {
    "dg": ("write_pacs", "dg_card_vs_cpu",
           ("vanilla", "ddaig", "daeldg", "crossgrad", "domainmix"), _dg_cut, "dg_run", "DG_RUNS"),
    "da": ("write_da_trees", "da_card_vs_cpu",
           ("source_only", "adda", "adabn", "dann", "mcd", "mme", "se", "m3sda", "dael", "cdac"),
           _da_cut, "da_run", "DA_RUNS"),
    "ssl": ("write_cifar10", "ssl_card_vs_cpu",
            ("fixmatch", "sup_baseline", "entmin", "mean_teacher", "mixmatch"), _ssl_cut,
            "ssl_run", "SSL_RUNS"),
}


@contextlib.contextmanager
def _listing_order(seed):
    """The DA and SSL loaders' unsorted folder listings in order ``seed``
    (``None``: the filesystem's own)."""
    from ovmr_tpu_torch.data.datasets import da, ssl

    saved = da.listdir_nohidden

    def listing(path, sort=False):
        items = saved(path, sort=True)
        if not sort:
            random.Random(seed).shuffle(items)
        return items

    if seed is not None:
        da.listdir_nohidden = ssl.listdir_nohidden = listing
    try:
        yield
    finally:
        da.listdir_nohidden = ssl.listdir_nohidden = saved


def _checked(failed, fn, *args):
    """``fn(*args)``; an AssertionError is printed and counted."""
    try:
        fn(*args)
    except AssertionError:
        failed.append(fn.__name__)
        traceback.print_exc(limit=0, file=sys.stdout)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--phase", required=True, choices=sorted(PHASES))
    parser.add_argument("--lr-cuts", type=float, nargs="+", default=None,
                        help="cuts of every recipe's lr (default: the phase's own)")
    parser.add_argument("--grad-factor", type=float, default=1.2)
    parser.add_argument("--tags", nargs="+", default=None)
    parser.add_argument("--runs", action="store_true")
    parser.add_argument("--random-start", action="store_true",
                        help="da: gate the ResNet-50 recipes from their random init")
    parser.add_argument("--lpclip", action="store_true", help="ssl: run lpclip's part")
    parser.add_argument("--orders", type=int, default=None,
                        help="da, ssl: the gates under this many shuffled folder listings")
    args = parser.parse_args()
    write, gate, tags, set_cut, run, runs = PHASES[args.phase]
    if args.tags is not None and not set(args.tags) <= set(tags):
        parser.error(f"--tags: {args.phase}'s trainers are {', '.join(tags)}")
    if (args.random_start and args.phase != "da" or args.lpclip and args.phase != "ssl"
            or args.orders and args.phase == "dg"):
        parser.error("--random-start is da's, --lpclip ssl's, --orders da's and ssl's")
    import numpy as np
    import torch

    import chip_smoke as smoke

    if not torch.cuda.is_available():
        print("probe_torch_dassl_gates: no CUDA device is available", file=sys.stderr)
        return 1
    print(f"[device] {smoke.nvidia_smi_line()}; torch {torch.__version__}", flush=True)
    smoke.DG_GRAD_FACTOR = args.grad_factor
    smoke.GATE_DRIFT = True
    smoke.DA_GATE_ZERO_RESIDUAL = not args.random_start
    root = Path(tempfile.mkdtemp(prefix=f"ovmr_{args.phase}_gates_"))
    # torch's own TF32 defaults, as the phases set them
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True
    failed = []
    try:
        getattr(smoke, write)(np, root)
        if args.phase == "da":
            smoke.da_run(torch, np, root, "source_only")
        cuts = {k: getattr(smoke, k) for k in ("DG_GATE_LR", "DA_GATE_LR_CUT", "SSL_GATE_LR")}
        for order in range(args.orders) if args.orders else [None]:
            for cut in args.lr_cuts or [None]:
                for k, v in cuts.items():
                    setattr(smoke, k, v)
                if cut is not None:
                    set_cut(smoke, cut)
                for tag in args.tags or tags:
                    t = time.perf_counter()
                    print(f"[probe] order {order}, lr cut {cut}, {tag}", flush=True)
                    with _listing_order(order):
                        _checked(failed, getattr(smoke, gate), torch, np, root, tag)
                    print(f"[probe] order {order}, lr cut {cut}, {tag} in "
                          f"{time.perf_counter() - t:.1f} s", flush=True)
                    torch.cuda.empty_cache()
        if args.runs:
            for tag in getattr(smoke, runs):
                if (args.phase, tag) != ("da", "source_only"):
                    _checked(failed, getattr(smoke, run), torch, np, root, tag)
                    torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
        if args.lpclip:
            from ovmr_tpu_torch.ops import cuda_lib

            cuda_lib.build_all()
            _checked(failed, smoke.lpclip_phase, torch, np, root)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
        shutil.rmtree(root, ignore_errors=True)
    print(f"[probe] {len(failed)} checks failed", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
