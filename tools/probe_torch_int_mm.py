#!/usr/bin/env python3
"""Which shapes ``torch._int_mm`` (cuBLASLt's int8 GEMM) takes on this card.

    python3 tools/probe_torch_int_mm.py

Tries int8 ``[M, K] @ [K, N]`` for rows M in 17-308, depths K in 8-768 and
widths N in 8-2304 (K and N multiples of 8, as torch asks), each checked
against an int64 product on the CPU, and prints the card's name and power
limit, one line a refused shape and a summary. ``ovmr_tpu_torch.ops.quant
.int_mm`` pads to what this shows the card takes. Exits non-zero without a
card.
"""

import itertools
import subprocess
import sys

import torch

ROWS = (17, 20, 24, 31, 32, 33, 48, 64, 77, 96, 308)
DEPTHS = (8, 16, 32, 64, 96, 128, 256, 768)
WIDTHS = (8, 16, 24, 32, 48, 64, 96, 192, 256, 768, 2304)


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_torch_int_mm: no CUDA device is available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), torch.__version__, torch.version.cuda)
    refused = []
    for m, k, n in itertools.product(ROWS, DEPTHS, WIDTHS):
        a = torch.randint(-127, 128, (m, k), dtype=torch.int8, device="cuda")
        b = torch.randint(-127, 128, (k, n), dtype=torch.int8, device="cuda")
        try:
            c = torch._int_mm(a, b)
            torch.cuda.synchronize()
        except RuntimeError as e:  # the library's refusal of this shape is the finding
            refused.append((m, k, n))
            print(f"refused {m} x {k} x {n}: {str(e)[:80]}")
            continue
        if not torch.equal(c.cpu(), (a.cpu().long() @ b.cpu().long()).int()):
            raise AssertionError(f"wrong product at {m} x {k} x {n}")
    total = len(ROWS) * len(DEPTHS) * len(WIDTHS)
    print(f"{total - len(refused)} of {total} shapes taken; refused: rows not a multiple of 32 "
          f"in {sum(1 for m, _, _ in refused if m % 32)} and a multiple in "
          f"{sum(1 for m, _, _ in refused if m % 32 == 0)}; depths of the refused "
          f"{sorted({k for _, k, _ in refused})}, widths {sorted({n for _, _, n in refused})}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
