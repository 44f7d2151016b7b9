#!/usr/bin/env python3
"""Wall time of ViT-B/16 ``OVMRGenerator.generate()`` requests (32 classes x
16 exemplars, bf16, seeded random towers and aggregator) for the package of
one checkout, on one CUDA card.

    python3 tools/ab_torch_request.py [--root CHECKOUT] [--requests N]

``--root`` names the checkout whose ``ovmr_tpu_torch`` is timed (default:
this one), so that two versions can be compared in one call: run them in
turns (parent, change, change, parent, ...). After two warm-up requests,
each of ``--requests`` requests is timed to a synchronise; then one more
request is split into its exemplar encode and the rest (text towers,
aggregator, fusion), each to a synchronise. Prints the card's name and
power limit first and one JSON line last. Exits non-zero without a card.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE), help="checkout whose package is timed")
    ap.add_argument("--requests", type=int, default=10)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("ab_torch_request: no CUDA device is available", file=sys.stderr)
        return 1
    from ovmr_tpu_torch.api import OVMRGenerator
    from ovmr_tpu_torch.models import clip as tclip
    from ovmr_tpu_torch.models.aggregator import init_aggregator
    from ovmr_tpu_torch.ops import cuda_lib

    if not cuda_lib.__file__.startswith(str(root)):
        raise RuntimeError(f"imported {cuda_lib.__file__}, not the package under {root}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    cuda_lib.build_all()
    cfg = tclip.VIT_B16
    gen = OVMRGenerator(tclip.init_params(cfg, seed=0), cfg,
                        init_aggregator(width=cfg.embed_dim, n_ctx=2, seed=0),
                        dtype=torch.bfloat16, device="cuda")
    g = torch.Generator().manual_seed(1)
    n_cls, shots, size = 32, 16, cfg.image_resolution
    images = torch.randn(n_cls, shots, 3, size, size, generator=g).to("cuda")
    names = [f"class {i}" for i in range(n_cls)]

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3, out

    for _ in range(2):
        timed(lambda: gen.generate(names, images))
    walls = [timed(lambda: gen.generate(names, images))[0] for _ in range(args.requests)]
    enc_ms, feats = timed(lambda: gen.encode_images(images.reshape(n_cls * shots, 3, size,
                                                                   size)))
    rest_ms, _ = timed(lambda: gen.generate_from_features(names,
                                                          feats.reshape(n_cls, shots, -1)))
    row = dict(root=str(root), device=smi, request_ms=walls,
               median_ms=statistics.median(walls), encode_ms=enc_ms, rest_ms=rest_ms)
    print(f"requests: median {row['median_ms']:.1f} ms ({min(walls):.1f}-{max(walls):.1f}); "
          f"encode {enc_ms:.1f} ms, text + aggregator + fusion {rest_ms:.1f} ms", flush=True)
    print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
