#!/usr/bin/env python3
"""K6 (``fused_attention``) of the PyTorch/CUDA port at the aggregator's
shapes, its time split into the host's and the device's, for the package
of one checkout.

    python3 tools/ab_torch_k6.py [--root CHECKOUT]

``--root`` names the checkout whose ``ovmr_tpu_torch`` is timed (default:
this one), so that two versions can be compared in one call on one card:
run parent, change, change, parent. Shapes: [32, 8, 18, 64] (ViT-B/16),
[32, 12, 18, 64] (ViT-L/14@336px), bf16 and fp32, through the entry the
aggregator calls, under ``torch.no_grad()`` as serving runs it. For each
shape and dtype, and for SDPA on the same q, k, v: the wall time a call of
200 back-to-back calls (CUDA events), the host's time to issue one call
(no synchronise inside the window) and the device's time a call
(torch.profiler), each the median of five rounds (the profile: one round).
Prints the card's name and power limit first and one JSON line last.
Exits non-zero without a card.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE), help="checkout whose package is timed")
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("ab_torch_k6: no CUDA device is available", file=sys.stderr)
        return 1
    from ovmr_tpu_torch.ops import cuda_lib
    from ovmr_tpu_torch.ops.attention import fused_attention, fused_attention_plain

    if not cuda_lib.__file__.startswith(str(root)):
        raise RuntimeError(f"imported {cuda_lib.__file__}, not the package under {root}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    cuda_lib.build_all()

    def wall_ms(fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.reps

    def host_ms(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(args.reps):
            fn()
        ms = (time.perf_counter() - t) * 1e3 / args.reps
        torch.cuda.synchronize()
        return ms

    def device_ms(fn):
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.reps):
                fn()
            torch.cuda.synchronize()
        us = sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        return us / 1e3 / args.reps

    rows = []
    with torch.no_grad():
        for n, h, l, dh in ((32, 8, 18, 64), (32, 12, 18, 64)):
            for dtype in (torch.bfloat16, torch.float32):
                g = torch.Generator(device="cuda").manual_seed(l * h)
                q, k, v = (torch.randn(n, h, l, dh, generator=g, device="cuda").to(dtype)
                           for _ in range(3))
                got, ref = fused_attention(q, k, v), fused_attention_plain(q, k, v)
                err = float((got.float() - ref.float()).abs().max())
                row = dict(shape=[n, h, l, dh], dtype=str(dtype).removeprefix("torch."),
                           max_abs_err=err)
                for side, fn in (("kernel", lambda: fused_attention(q, k, v)),
                                 ("sdpa", lambda: F.scaled_dot_product_attention(q, k, v))):
                    for _ in range(20):
                        fn()
                    row[f"{side}_wall_ms"] = sorted(wall_ms(fn) for _ in range(5))[2]
                    row[f"{side}_host_ms"] = sorted(host_ms(fn) for _ in range(5))[2]
                    row[f"{side}_device_ms"] = device_ms(fn)
                print(f"K6 {row['shape']} {row['dtype']}: err {err:.3g}; kernel wall "
                      f"{row['kernel_wall_ms']:.4f} ms, host {row['kernel_host_ms']:.4f}, "
                      f"device {row['kernel_device_ms']:.4f}; sdpa wall {row['sdpa_wall_ms']:.4f}, "
                      f"host {row['sdpa_host_ms']:.4f}, device {row['sdpa_device_ms']:.4f}",
                      flush=True)
                rows.append(row)
    print(json.dumps({"root": str(root), "device": smi, "k6": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
