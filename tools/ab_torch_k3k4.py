#!/usr/bin/env python3
"""K3 (``attn_half_bwd_dx``) and K4 (``mlp_half_bwd_dx``) of the PyTorch/CUDA
port, timed whole and split into their launches, for the package of one
checkout.

    python3 tools/ab_torch_k3k4.py [--root CHECKOUT] [--reps N]

``--root`` names the checkout whose ``ovmr_tpu_torch`` is timed (default:
this one), so that two versions can be compared in one call on one card:
run parent, change, change, parent. Shapes, bf16: the training step's text
tower (192 prompts x 77 tokens, width 512, 8 heads, causal; K3 masked) and
``chip_smoke.py`` phase 11's ViT-L/14@336px vision blocks at 32 images
(577 tokens, width 1024, 16 heads, hidden 4096; K3 unmasked). For each
shape and kernel: the check against the plain twin (max abs error), the
wall time of one call (CUDA events over ``--reps`` back-to-back calls, the
median, least and largest of five rounds) and the device time of each
launch inside a call (torch.profiler over ``--reps`` calls, by kernel name,
in the order of first launch). Where the package has K4's one-launch dh_pre
(``mlp_bwd_dh``), also K4's c_fc recompute and GELU' product both ways: as
the two launches (fp32 h_pre through device memory) and as the one, the
results compared bit for bit and each timed as above. Prints the card's
name and power limit first and one JSON line last. Exits non-zero without
a card.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]

# (case, B, L, D, heads, causal)
CASES = (("text-train", 192, 77, 512, 8, True),
         ("vitl336-vision-bwd", 32, 577, 1024, 16, False))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE), help="checkout whose package is timed")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("ab_torch_k3k4: no CUDA device is available", file=sys.stderr)
        return 1
    from ovmr_tpu_torch.ops import cuda_lib
    from ovmr_tpu_torch.ops.block_fused_bwd import (
        attn_half_bwd_dx,
        attn_half_bwd_dx_plain,
        mlp_half_bwd_dx,
        mlp_half_bwd_dx_plain,
    )
    from ovmr_tpu_torch.ops import block_fused_bwd as bwd
    from ovmr_tpu_torch.ops.layers import causal_mask, layer_norm

    if not cuda_lib.__file__.startswith(str(root)):
        raise RuntimeError(f"imported {cuda_lib.__file__}, not the package under {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    cuda_lib.build_all()

    def wall_ms(fn):
        means = []
        for _ in range(5):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(args.reps):
                fn()
            end.record()
            torch.cuda.synchronize()
            means.append(start.elapsed_time(end) / args.reps)
        means.sort()
        return means[2], means[0], means[-1]

    def split(fn):
        """(kernel name, device ms a call, launches a call), in launch order."""
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.reps):
                fn()
            torch.cuda.synchronize()
        order = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                order.setdefault(e.name, len(order))
        rows = [(e.key, getattr(e, "self_device_time_total", 0) / 1e3 / args.reps,
                 e.count / args.reps)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        rows.sort(key=lambda r: order.get(r[0], len(order)))
        return [dict(kernel=k, ms=ms, launches=n) for k, ms, n in rows if ms > 0]

    out = []
    for case, b, l, d, h, causal in CASES:
        g = torch.Generator(device="cuda").manual_seed(l * h)

        def randn(*shape, std=1.0):
            return (torch.randn(*shape, generator=g, device="cuda") * std).to(torch.bfloat16)

        x, gr = randn(b, l, d), randn(b, l, d)
        ln_s, ln_b = 1 + randn(d, std=0.1), randn(d, std=0.1)
        mask = causal_mask(l, device="cuda") if causal else None
        k3 = (x, gr, randn(d, 3 * d, std=d ** -0.5), randn(3 * d, std=0.02),
              randn(d, d, std=d ** -0.5), ln_s, ln_b)
        k4 = (x, gr, randn(d, 4 * d, std=d ** -0.5), randn(4 * d, std=0.02),
              randn(4 * d, d, std=(4 * d) ** -0.5), ln_s, ln_b)
        for name, fn, plain in (
                ("K3", lambda: attn_half_bwd_dx(*k3, mask=mask, n_head=h),
                 lambda: attn_half_bwd_dx_plain(*k3, mask=mask, n_head=h)),
                ("K4", lambda: mlp_half_bwd_dx(*k4), lambda: mlp_half_bwd_dx_plain(*k4))):
            got, ref = fn(), plain()
            err = float((got.float() - ref.float()).abs().max())
            del got, ref
            for _ in range(3):
                fn()
            ms, lo, hi = wall_ms(fn)
            parts = split(fn)
            row = dict(case=case, kernel=name, shape=[b, l, d, h], max_abs_err=err, ms=ms,
                       ms_spread=[lo, hi], split=parts)
            print(f"{name} {case} {row['shape']}: err {err:.3g}; {ms:.4f} ms ({lo:.4f}-{hi:.4f})",
                  flush=True)
            for p in parts:
                print(f"    {p['ms']:.4f} ms x{p['launches']:g}  {p['kernel'][:110]}", flush=True)
            out.append(row)
        if not hasattr(bwd, "mlp_bwd_dh"):
            continue
        xln = layer_norm(x, ln_s, ln_b)
        c_fc_w, c_fc_b, c_proj_w = k4[2:5]

        def pair():
            h_pre = bwd.block_gemm_bwd(xln, c_fc_w, "bias_f32", bias=c_fc_b)
            return bwd.block_gemm_bwd(gr, c_proj_w, "gelu_grad", h_pre=h_pre)

        def fused():
            return bwd.mlp_bwd_dh(xln, c_fc_w, c_fc_b, gr, c_proj_w)

        equal = bool(torch.equal(pair(), fused()))
        row = dict(case=case, kernel="K4 dh_pre", shape=[b, l, d, 4 * d], bit_equal=equal)
        for side, fn in (("pair", pair), ("fused", fused), ("pair", pair), ("fused", fused)):
            row.setdefault(f"{side}_ms", []).append(wall_ms(fn)[0])
        print(f"K4 dh_pre {case}: bit-equal {equal}; two launches {row['pair_ms']} ms, one "
              f"launch {row['fused_ms']} ms", flush=True)
        out.append(row)
    print(json.dumps({"root": str(root), "device": smi, "rows": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
