#!/usr/bin/env python3
"""K1 of the PyTorch/CUDA port with its two products on the wgmma/TMA GEMM
against the same wrapper with them on gemm.cuh's WMMA GEMM, in one process
on one CUDA card, alternating which side runs first.

    python3 tools/ab_torch_k1_gemm.py

At the text tower's host-bound shapes (ViT-B/16: 32 and 96 prompts x 77
tokens x 512, 8 heads; ViT-L/14@336px: 32 x 77 x 768, 12 heads), bf16,
causal. Each side: six medians of five means over 10 calls (CUDA events,
``chip_smoke.cuda_ms``); beside them the attention core alone, whose code
is the same on both sides, as a measure of the host's drift. Prints the
card's name and power limit first. Exits non-zero without a card.
"""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ab_torch_k1_gemm: no CUDA device is available", file=sys.stderr)
        return 1
    from chip_smoke import cuda_ms
    from ovmr_tpu_torch.ops import block_fused as bf
    from ovmr_tpu_torch.ops.layers import causal_mask

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    wgmma = bf._block_gemm

    def wmma(lib, code, a, w, bias, out, epilogue, stream, resid=None):
        bf._gemm(lib, code, a, w, bias, out, epilogue, stream, resid=resid)

    for b, l, d, h in ((32, 77, 512, 8), (96, 77, 512, 8), (32, 77, 768, 12)):
        g = torch.Generator(device="cuda").manual_seed(0)

        def r(*shape, std=1.0):
            return (torch.randn(*shape, generator=g, device="cuda") * std).bfloat16()

        x, qkv = r(b, l, d), r(b, l, 3 * d)
        w_qkv, b_qkv = r(d, 3 * d, std=d ** -0.5), r(3 * d, std=0.02)
        w_out, b_out = r(d, d, std=d ** -0.5), r(d, std=0.02)
        ln_s, ln_b = 1 + r(d, std=0.1), r(d, std=0.1)
        mask = causal_mask(l, device="cuda")
        times = {"wgmma": [], "wmma": [], "core alone": []}
        try:
            for i in range(6):
                for side in ("wgmma", "wmma") if i % 2 == 0 else ("wmma", "wgmma"):
                    bf._block_gemm = wgmma if side == "wgmma" else wmma
                    times[side].append(cuda_ms(lambda: bf.fused_attn_half(
                        x, w_qkv, b_qkv, w_out, b_out, ln_s, ln_b, mask=mask, n_head=h), 10)[0])
                    times["core alone"].append(cuda_ms(lambda: bf.attn_core(qkv, mask, h), 10)[0])
        finally:
            bf._block_gemm = wgmma
        for side, ts in times.items():
            ts.sort()
            print(f"K1-causal B{b} L{l} D{d} H{h} {side}: median {ts[len(ts) // 2]:.4f} ms, "
                  f"{' '.join(f'{t:.4f}' for t in ts)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
