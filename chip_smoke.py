#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ovmr_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing falls back):

1. Device: print the card's name and power limit (nvidia-smi) and build
   every kernel from ``ovmr_tpu_torch/csrc`` (one nvcc per source, in
   parallel) into ``build/ovmr_tpu_torch_kernels/``.
2. Kernels against their plain PyTorch versions on the card, at the shapes
   the three main paths give them. Serving at ViT-B/16, in bf16 and fp32:
   K1 (vision, unmasked, at generate()'s 512 exemplars and classify()'s 256
   queries; text, causal, at each 32-class prompt set, and at the three sets
   as one batch of 96), K2 (both towers, same shapes), K6 (aggregator). Training:
   K1 and K2 at the image-tower batches 768, 576 and 960 (bf16), and 384
   and 1152 (phase 12's splits of 2 and 6), and at the
   192 prompts of a class-grouped batch K1-causal, K2 and the dx backward
   kernels K3 (masked and unmasked) and K4, in bf16 and fp32; K6 at phase
   12's eval heads (192 classes x (8 shots + 2 vokens), bf16). Serving at
   ViT-L/14@336px (last, so the earlier cases run as they always did): K1
   (vision, 577 tokens x 1024, 16 heads) and
   K5 (the chunked MLP half, 2 chunks) at generate()'s 512 exemplars and
   classify()'s 256 queries in bf16 and at the fp32 phase's 4 images, K2 at
   K5's shape as a second yardstick (on no path), K1-causal and K2 at the
   32 prompts of a set (77 x 768, 12 heads), K6 at 12 heads; the plain
   versions of the big vision cases run 64 images at a time (a [512, 16,
   577, 577] fp32 score tensor is 10.9 GB). On a model axis of 2 (last):
   K7 and K8 at ViT-L/14@336px's shard shapes (vision 8 heads, dl 512,
   hidden 2048 at 512 and 256 images; text 6 heads, dl 384, hidden 1536,
   causal, at 32 prompts) in bf16 and at phase 10's 4 images and 8 prompts
   in fp32, and K7 on a shard of zero-padded heads, which must give exact
   zeros. K3 (no mask, the query-tiled core) at the vision towers' 197 x
   768 and 577 x 1024 and K4 at K5's shape, in bf16. The wgmma/TMA GEMM of
   K1, K2, K5, K7 and K8 alone at K5's c_fc/c_proj, K2's ViT-B/16 shapes,
   K1's QKV and out-proj, K7's q slice and fp32 out-proj and K8's c_fc and
   fp32 c_proj at ViT-L/14@336px, and at the six products of K3 and K4 in
   the training step's text tower (the transposed weights read as they are
   stored) and K4's one launch of both c_fc and g @ c_proj_w^T, with
   ``torch.matmul`` as its yardstick. K3's attention-backward
   core alone: the one-launch core at the training text tower's 192 x 77
   (causal) and the query-tiled pair at phase 11's ViT-L/14@336px 32 x 577,
   with ``torch.autograd.grad`` through SDPA as its yardstick.
   Beside every K1 and K7 case, the attention core those launch
   (``attn_core``) alone at the same B, L, width and heads, with SDPA on
   the same q/k/v as its library yardstick. Each case is checked as soon as it
   is built, and timed beside its plain version, one PyTorch library call
   chain computing the same function (a yardstick the port never calls; for K3 and K4
   ``torch.autograd.grad`` with respect to the input through the library
   forward) and its bound on the card; a time is the median of five means
   over back-to-back calls, with their spread.
3. The serving slice at ViT-B/16 in bf16 with seeded random towers and
   aggregator (n_ctx=2): three ``generate()`` requests of 32 classes x 16
   exemplars at 224x224, ``classify()`` of 256 queries in fusion mode,
   ``export()`` and reload. Launch counts are zeroed just before and read
   just after; every kernel of the path must have run, and every launch
   must have been at a shape that phase 2 checked and timed. Then the time
   split of one request and a torch.profiler breakdown of another.
4. The same path at fp32 (4 classes x 4 shots) on the card (kernels) and
   on the CPU (plain versions): classifiers within 1e-4, fusion weights
   within 1e-3.
5. The training slice at ViT-B/16 full width, bf16 towers, the flagship
   recipe (192 classes x 8 instances, adam, lr 2e-4, aggregator dropout
   0.1, n_ctx=2): one warm-up step and three timed steps at the split
   points 4, 3, 5. Per step the launch counts are exact (K1 24, K1-causal
   24 and their attention cores 48, K2 48, K4 24, K3-masked 24 and every
   one of its cores the one-launch short core, K6 0), the loss is finite,
   and on the
   first step every aggregator leaf has a finite non-zero gradient and
   changes. A second run from the same seeds, taken apart into image
   passes, heads forward, backward and optimizer (each ending in a
   synchronise), must give the same losses. Then a torch.profiler breakdown
   of one step.
6. One training step at fp32 (4 classes x 4 instances, split 2, dropout 0)
   on the card (kernels, K6 through its autograd wrapper) and on the CPU
   (plain twins): loss within 1e-4, every aggregator gradient within 1e-4
   of its scale, post-step parameters within 1e-5 on average (median 1e-6;
   at most 2 x lr for an element whose gradient plus decay is rounding
   noise, which Adam's normalisation amplifies to a full step).
7. The serving slice at ViT-L/14@336px, full width and depth (vision 24 x
   1024, 16 heads, patch 14, 336 px, 577 tokens; text 12 x 768, 12 heads;
   embed 768), bf16, seeded random towers through
   ``OVMRGenerator.from_checkpoints("ViT-L/14@336px")``: one warm-up and
   two timed ``generate()`` requests of 32 classes x 16 exemplars, then
   ``classify()`` of 256 queries. Exact launch counts per kernel and shape
   (per request 24 K1 + 24 K5 at 512 images, 36 K1-causal + 36 K2 at 32
   prompts, 4 K6; an attention core inside every K1), the request split,
   peak device memory, a torch.profiler breakdown.
8. The same path at fp32 on 2 classes x 2 shots, on the card and on the
   CPU: classifiers within 1e-4, fusion weights within 1e-3.
9. The same ViT-L/14@336px towers (phase 7's, bf16) on a model axis of 2
   local shards, through the MM_CLS_OP serving seams
   (``engine.trainer.tp_seam_tools``, ``make_feature_extractor``,
   ``mm_generate_classifiers``): one warm-up and two timed requests of
   32 x 16, then 256 queries through the TP encode and ``eval_logits``.
   Launch counts exact per request (K7 48 at 512 images, K7-causal 72 and
   K8 48 + 72, K6 4, an attention core inside every K7; K1, K2 and K5
   none) and per classify; the classifiers
   held against phase 7's for the same requests by a cosine floor; the
   request split and a torch.profiler breakdown.
10. Phase 8's fp32 request and queries on the model axis on the card,
   against phase 8's CPU single-device result: classifiers within 1e-4,
   fusion weights within 1e-3.
11. ``loss.backward()`` through two ViT-L/14@336px vision blocks (K1 + K5
   forward, K4 + K3 backward, exact launch counts): fp32 on the card
   against the CPU (dx within 1e-4 of its scale), bf16 on the card finite.
12. The MM_CLS_OP trainer through its entry point,
   ``ovmr_tpu_torch.train.main`` called in this process with the flagship
   recipe as command-line options (ViT-B/16 full width and depth, bf16,
   seeded random towers; RandomClassSampler 192 classes x 8 instances,
   adam lr 2e-4 with a constant 1e-5 warm-up epoch and cosine, n_ctx 2,
   test batch 256; the flagship's train transforms where PIL is
   installed) over ``Synthetic`` at ``OVMR_SYNTHETIC=192,16,224`` with 8
   shots, so an epoch is one batch of 1536 images and 768 test images
   remain. Train 2 epochs (a checkpoint each), run again to 3 epochs on the
   same output directory (it must resume at epoch 2 with adam's step count
   and moments as saved; its epoch is profiled), then the fusion eval of
   epoch 3. Every step's launches are exact (phase 5's counts), the loss
   finite, the checkpoint files and pointer are written, and the eval
   writes ``mm_classifiers.pt`` at 192 classes with unit rows and fusion
   rows summing to 1, the CSVs and the ``=> result`` block. Prints step and
   epoch walls with the trainer's data meter, the eval's split, the
   device's busy share over the profiled epoch and peak memory.

In bf16 every K1, K2 and K8 launches the wgmma GEMM twice, every K5 twice
a chunk, every K4 twice (its c_fc recompute and GELU' product are one
launch), every K3 three times and every K7 four times (``gemm_wgmma``,
counted by name); phases 3, 5, 7, 9, 11 and 12 check that
count exactly, and phase 6 that fp32 launches none (and runs K3's tiled
FMA core). K6 runs at the aggregator's shapes, where the host's time to issue a
call may bound it: its rows add the host's milliseconds a call and the
device's (torch.profiler), for the kernel and for SDPA.

Prints the kernels JSON line, the nvidia-smi line and, last, the result
line ``{"ok": true, "device": {...}}``. Exits non-zero without a result
when no CUDA device is available or the package is not beside the script.
"""

from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# published H100 SXM peaks (dense): bf16 tensor cores, fp32 without them,
# HBM3 bandwidth
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
HBM_BYTES_S = 3.35e12


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int, rounds: int = 5):
    """Device milliseconds of one call of ``fn``: the median, least and
    largest of ``rounds`` means, each over ``reps`` back-to-back calls
    (CUDA events, after one warm-up call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    means = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        means.append(start.elapsed_time(end) / reps)
    means.sort()
    return means[len(means) // 2], means[0], means[-1]


def host_ms(fn, reps: int, rounds: int = 5) -> float:
    """Host milliseconds to issue one call of ``fn``: the median of
    ``rounds`` means over ``reps`` back-to-back calls, each timed from a
    synchronised device to the last call's return (no synchronise inside
    the window, so the device's time is not in it while the queue does not
    fill)."""
    import torch

    fn()
    means = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        means.append((time.perf_counter() - t) * 1e3 / reps)
    torch.cuda.synchronize()
    means.sort()
    return means[len(means) // 2]


def device_ms(torch, fn, reps: int) -> float:
    """Device milliseconds a call of ``fn`` keeps the card busy: the
    kernels' time (torch.profiler) over ``reps`` calls, over ``reps``."""
    fn()
    torch.cuda.synchronize()
    _, rows = device_times(torch, lambda: [fn() for _ in range(reps)])
    return sum(r[0] for r in rows) / reps


def tolerance(dtype, ref) -> float:
    """bf16: two units in the last place at the output's largest magnitude
    (the kernel and the plain version may round one sum to a neighbouring
    bf16 value); fp32: 1e-5 of the output scale (sums of up to 3072
    products taken in another order)."""
    import torch

    peak = max(float(ref.abs().max()), 1.0)
    if dtype == torch.bfloat16:
        return 2.0 * 2.0 ** (math.floor(math.log2(peak)) - 7)
    return 1e-5 * peak


def bound_ms(bytes_moved: float, flops: float, peak: float):
    t_bytes, t_ops = bytes_moved / HBM_BYTES_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against plain
# ---------------------------------------------------------------------------

def kernel_checks(torch, F):
    from ovmr_tpu_torch.ops import cuda_lib
    from ovmr_tpu_torch.ops.attention import fused_attention, fused_attention_plain
    from ovmr_tpu_torch.ops.block_fused import (
        attn_core,
        attn_core_plain,
        fused_attn_half,
        fused_attn_half_plain,
        fused_mlp_half,
        fused_mlp_half_chunked,
        fused_mlp_half_chunked_plain,
        fused_mlp_half_plain,
        mlp_tier_chunks,
    )
    from ovmr_tpu_torch.ops.block_fused_bwd import (
        attn_half_bwd_dx,
        attn_half_bwd_dx_plain,
        mlp_half_bwd_dx,
        mlp_half_bwd_dx_plain,
    )
    from ovmr_tpu_torch.ops.layers import causal_mask

    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, std=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * std

    def layer(d):
        return {
            "w_qkv": randn(d, 3 * d, std=d ** -0.5), "b_qkv": randn(3 * d, std=0.02),
            "w_out": randn(d, d, std=d ** -0.5), "b_out": randn(d, std=0.02),
            "ln_1_scale": 1 + randn(d, std=0.1), "ln_1_bias": randn(d, std=0.1),
            "c_fc_w": randn(d, 4 * d, std=d ** -0.5), "c_fc_b": randn(4 * d, std=0.02),
            "c_proj_w": randn(4 * d, d, std=(4 * d) ** -0.5), "c_proj_b": randn(d, std=0.02),
            "ln_2_scale": 1 + randn(d, std=0.1), "ln_2_bias": randn(d, std=0.1),
        }

    def library_attn_half(x, p, mask, h):
        b, l, d = x.shape
        qkv = F.linear(F.layer_norm(x, (d,), p["ln_1_scale"], p["ln_1_bias"]),
                       p["w_qkv"].t(), p["b_qkv"])
        q, k, v = qkv.view(b, l, 3, h, d // h).permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        return x + F.linear(o.transpose(1, 2).reshape(b, l, d), p["w_out"].t(), p["b_out"])

    def library_mlp_half(x, p):
        d = x.shape[-1]
        hdn = F.linear(F.layer_norm(x, (d,), p["ln_2_scale"], p["ln_2_bias"]),
                       p["c_fc_w"].t(), p["c_fc_b"])
        hdn = hdn * torch.sigmoid(1.702 * hdn)  # QuickGELU
        return x + F.linear(hdn, p["c_proj_w"].t(), p["c_proj_b"])

    def library_dx(half, x, g, *args):
        """The input cotangent by autograd through the library forward."""
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            out = half(x, *args)
        return torch.autograd.grad(out, x, g)[0]

    def sliced(fn, x, step):
        """``fn`` over batch slices of ``x``, so that a plain version's fp32
        scores or hidden activations of 512 images never exist at once."""
        if step >= x.shape[0]:
            return lambda: fn(x)
        return lambda: torch.cat([fn(x[s : s + step]) for s in range(0, x.shape[0], step)])

    results = []

    def check(c):
        """Hold one case's kernel against its plain version, then time both,
        the library yardstick and the bound. Each case is checked as soon as
        it is built, so only one row's tensors are alive at a time."""
        got = c["kernel"]()
        ref = c["plain"]()
        torch.cuda.synchronize()
        err = float((got.float() - ref.float()).abs().max())
        tol = tolerance(c["dtype"], ref)
        finite = bool(torch.isfinite(got).all())
        dt = "bf16" if c["dtype"] == torch.bfloat16 else "fp32"
        label = f"{c['name']}/{c['case']}/{dt}"
        print(f"[kernels] {label} {c['shape']}: max_abs_err {err:.3g} (tol {tol:.3g})",
              flush=True)
        if not finite or not err <= tol:
            raise AssertionError(f"{label}: kernel disagrees with its plain version "
                                 f"(max_abs_err {err}, tol {tol}, finite {finite})")
        rounds = c.get("rounds", 5)  # the kernel always gets five rounds
        kernel_ms, k_lo, k_hi = cuda_ms(c["kernel"], c["reps"])
        plain_ms = cuda_ms(c["plain"], c["reps"], rounds)[0]
        library_ms = cuda_ms(c["library"], c["reps"], rounds)[0]
        b_ms, b_by = bound_ms(c["bytes"], c["flops"], c["peak"])
        print(f"[kernels] {label}: kernel {kernel_ms:.4f} ms ({k_lo:.4f}-{k_hi:.4f}), "
              f"plain {plain_ms:.4f} ms, library {library_ms:.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_by})", flush=True)
        row = dict(
            name=label, kernel=c["name"], route="cuda", source=c["source"],
            replaces=c["replaces"], case=c["case"], shape=c["shape"], dtype=dt,
            shape_key=cuda_lib.shape_key(c["name"], c.get("key_shape", c["x"].shape), c["dtype"]),
            max_abs_err=err, tol=tol, ms=kernel_ms, kernel_ms=kernel_ms,
            ms_spread=[k_lo, k_hi], plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=b_ms, bound_by=b_by,
        )
        if c.get("host_bound"):
            # where the host may bound a call: the host's time to issue one
            # call, apart from the device's time per launch
            for side in ("kernel", "library"):
                host, device = host_ms(c[side], c["reps"]), device_ms(torch, c[side], c["reps"])
                row[f"{side}_host_ms"], row[f"{side}_device_ms"] = host, device
                print(f"[kernels] {label}: {side} host {host:.4f} ms a call, device "
                      f"{device:.4f} ms a call", flush=True)
        results.append(row)

    def check_core(case, b, l, w, h, mask, dtype, replaces, timing):
        """The attention core alone at a K1 or K7 launch's shape: ``qkv [b, l,
        3w]`` of unit variance, its ``h`` heads against the plain twin, and
        as library SDPA on the same q/k/v (an additive mask where the
        path has one)."""
        qkv = randn(b, l, 3 * w).to(dtype)
        q, k, v = qkv.view(b, l, 3, h, w // h).permute(2, 0, 3, 1, 4)
        lib_mask = None if mask is None else mask.to(dtype)
        pairs = l * (l + 1) // 2 if mask is not None else l * l
        step = 64 if b * h * l * l * 4 > 2 ** 32 else b
        check(dict(
            name="attn_core", case=case, dtype=dtype, shape=[b, l, w, h], x=qkv,
            key_shape=(b, l, w, h), source="ovmr_tpu_torch/csrc/block_fused.cu",
            replaces=replaces,
            kernel=lambda: attn_core(qkv, mask, h),
            plain=sliced(lambda t: attn_core_plain(t, mask, h), qkv, step),
            library=lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=lib_mask),
            # q, k, v read and the heads written once; q.k and probs.v
            bytes=4 * b * l * w * qkv.element_size() + (l * l * 4 if mask is not None else 0),
            flops=4 * b * pairs * w,
            peak=PEAK_BF16 if dtype != torch.float32 else PEAK_FP32, **timing,
        ))

    params = {}
    both = (torch.bfloat16, torch.float32)
    bf16, fp32 = both[:1], both[1:]
    # (case, B, L, D, heads, causal, dtypes, backward too). Serving:
    # generate()'s exemplar encode (32 x 16 images), classify()'s 256
    # queries, one 32-class prompt set (text, mm and v each), and the three
    # sets as one batch (not on the path). Training: the image-tower batches
    # of 192 classes x 8 instances at the split points 4, 3 and 5, and the
    # 192 prompts of each set, forward and backward.
    for case, b, l, d, h, masked, dtypes, bwd in (
            ("vision-encode", 512, 197, 768, 12, False, both, False),
            ("vision-classify", 256, 197, 768, 12, False, both, False),
            ("text-prompts", 32, 77, 512, 8, True, both, False),
            ("text-3sets", 96, 77, 512, 8, True, both, False),
            ("vision-train-768", 768, 197, 768, 12, False, both[:1], False),
            ("vision-train-576", 576, 197, 768, 12, False, both[:1], False),
            ("vision-train-960", 960, 197, 768, 12, False, both[:1], False),
            # phase 12's trainer draws its split from [2, 6): 192 x 2 queries
            # beside 192 x 6 exemplars
            ("vision-train-384", 384, 197, 768, 12, False, both[:1], False),
            ("vision-train-1152", 1152, 197, 768, 12, False, both[:1], False),
            ("text-train", 192, 77, 512, 8, True, both, True),
            # ViT-L/14@336px serving: the exemplar encode, classify()'s
            # queries, the fp32 phase's 4 images, one 32-class prompt set
            ("vitl336-vision-encode", 512, 577, 1024, 16, False, bf16, False),
            ("vitl336-vision-classify", 256, 577, 1024, 16, False, bf16, False),
            ("vitl336-vision-fp32", 4, 577, 1024, 16, False, fp32, False),
            ("vitl336-text-prompts", 32, 77, 768, 12, True, both, False),):
        p32 = params.setdefault(d, layer(d))
        x32 = randn(b, l, d)
        chunks = mlp_tier_chunks(l, d, 4 * d)  # > 0: this tower's MLP half is K5
        # the plain and library versions run 64 images at a time where the
        # fp32 scores of the whole batch would take more than 4 GiB
        step = 64 if b * h * l * l * 4 > 2 ** 32 else b
        g32 = randn(b, l, d) if bwd else None
        mask = causal_mask(l, device="cuda") if masked else None
        name_k1 = "fused_attn_half_masked" if masked else "fused_attn_half"
        for dtype in dtypes:
            p = {k: v.to(dtype) for k, v in p32.items()}
            x = x32.to(dtype)
            it = x.element_size()
            tok = b * l
            peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_FP32
            timing = dict(reps=10 if dtype == torch.bfloat16 and step == b else 3,
                          rounds=5 if step == b else 3)
            attn_pairs = l * (l + 1) // 2 if masked else l * l
            a_args = (x, p["w_qkv"], p["b_qkv"], p["w_out"], p["b_out"],
                      p["ln_1_scale"], p["ln_1_bias"])
            m_args = (x, p["c_fc_w"], p["c_fc_b"], p["c_proj_w"], p["c_proj_b"],
                      p["ln_2_scale"], p["ln_2_bias"])
            lib_mask = None if mask is None else mask.to(dtype)
            check(dict(
                name=name_k1, case=case, dtype=dtype, shape=[b, l, d, h], x=x,
                source="ovmr_tpu_torch/csrc/block_fused.cu",
                replaces=("ovmr_tpu/ops/block_fused.py:113" if masked
                          else "ovmr_tpu/ops/block_fused.py:58"),
                kernel=lambda a=a_args, m=mask, h=h: fused_attn_half(*a, mask=m, n_head=h),
                plain=sliced(lambda xs, a=a_args, m=mask, h=h: fused_attn_half_plain(
                    xs, *a[1:], mask=m, n_head=h), x, step),
                library=sliced(lambda xs, p=p, m=lib_mask, h=h: library_attn_half(xs, p, m, h),
                               x, step),
                bytes=(2 * tok * d + 4 * d * d + 6 * d) * it + (l * l * 4 if masked else 0),
                flops=2 * tok * d * 4 * d + 4 * b * attn_pairs * d,
                peak=peak, **timing,
            ))
            check_core(case, b, l, d, h, mask, dtype, "ovmr_tpu/ops/block_fused.py:78", timing)
            mlp = dict(
                case=case, dtype=dtype, shape=[b, l, d, 4 * d], x=x,
                source="ovmr_tpu_torch/csrc/block_fused.cu",
                library=sliced(lambda xs, p=p: library_mlp_half(xs, p), x, step),
                bytes=(2 * tok * d + 8 * d * d + 7 * d) * it,
                flops=4 * tok * d * 4 * d,
                peak=peak, **timing,
            )
            if chunks:  # K5 on the path; K2 at the same shape as a yardstick (on no path)
                check(dict(
                    mlp, name="fused_mlp_half_chunked",
                    replaces="ovmr_tpu/ops/block_fused.py:249",
                    kernel=lambda a=m_args, c=chunks: fused_mlp_half_chunked(*a, chunks=c),
                    plain=sliced(lambda xs, a=m_args, c=chunks: fused_mlp_half_chunked_plain(
                        xs, *a[1:], chunks=c), x, step),
                ))
            check(dict(
                mlp, name="fused_mlp_half", replaces="ovmr_tpu/ops/block_fused.py:123",
                kernel=lambda a=m_args: fused_mlp_half(*a),
                plain=sliced(lambda xs, a=m_args: fused_mlp_half_plain(xs, *a[1:]), x, step),
            ))
            if not bwd:
                continue
            g = g32.to(dtype)
            # K3 with the causal mask (the text tower's backward) and without
            for m, lm, pairs in ((mask, lib_mask, attn_pairs), (None, None, l * l)):
                k3_args = (x, g, p["w_qkv"], p["b_qkv"], p["w_out"],
                           p["ln_1_scale"], p["ln_1_bias"])
                check(dict(
                    name="attn_half_bwd_dx_masked" if m is not None else "attn_half_bwd_dx",
                    case=case, dtype=dtype, shape=[b, l, d, h], x=x,
                    source="ovmr_tpu_torch/csrc/block_fused_bwd.cu",
                    replaces=("ovmr_tpu/ops/block_fused_bwd.py:219" if m is not None
                              else "ovmr_tpu/ops/block_fused_bwd.py:128"),
                    kernel=lambda a=k3_args, m=m, h=h: attn_half_bwd_dx(*a, mask=m, n_head=h),
                    plain=lambda a=k3_args, m=m, h=h: attn_half_bwd_dx_plain(*a, mask=m, n_head=h),
                    library=lambda x=x, g=g, p=p, m=lm, h=h: library_dx(
                        library_attn_half, x, g, p, m, h),
                    # x and g read, dx written, w_qkv, w_out, b_qkv, LN1; the
                    # QKV, dattn and dxln products plus five [L, L] products a head
                    bytes=(3 * tok * d + 4 * d * d + 5 * d) * it
                    + (l * l * 4 if m is not None else 0),
                    flops=2 * tok * d * 7 * d + 10 * b * pairs * d,
                    peak=peak, **timing,
                ))
            k4_args = (x, g, p["c_fc_w"], p["c_fc_b"], p["c_proj_w"],
                       p["ln_2_scale"], p["ln_2_bias"])
            check(dict(
                name="mlp_half_bwd_dx", case=case, dtype=dtype, shape=[b, l, d, 4 * d], x=x,
                source="ovmr_tpu_torch/csrc/block_fused_bwd.cu",
                replaces="ovmr_tpu/ops/block_fused_bwd.py:57",
                kernel=lambda a=k4_args: mlp_half_bwd_dx(*a),
                plain=lambda a=k4_args: mlp_half_bwd_dx_plain(*a),
                library=lambda x=x, g=g, p=p: library_dx(library_mlp_half, x, g, p),
                # y and g read, dy written, c_fc_w, c_proj_w, c_fc_b, LN2;
                # three [tokens, D] x [D, 4D] products
                bytes=(3 * tok * d + 8 * d * d + 6 * d) * it,
                flops=3 * 2 * tok * d * 4 * d,
                peak=peak, **timing,
            ))
    # the aggregator at embed width 512 (8 heads) and ViT-L's 768 (12 heads);
    # on the fp32 TP check's 2 classes padded to 8, 2 shots + 2 vokens; at
    # phase 12's eval, 192 classes of 8 shots + 2 vokens
    for case, n, h, l, dh, dtypes in (("aggregator", 32, 8, 18, 64, both),
                                      ("trainer-aggregator", 192, 8, 10, 64, bf16),
                                      ("vitl336-aggregator", 32, 12, 18, 64, both),
                                      ("vitl336-tp-fp32-aggregator", 8, 12, 4, 64, fp32)):
        for dtype in dtypes:
            q, k, v = (randn(n, h, l, dh).to(dtype) for _ in range(3))
            check(dict(
                name="fused_attention", case=case, dtype=dtype, shape=[n, h, l, dh], x=q,
                source="ovmr_tpu_torch/csrc/attention.cu",
                replaces="ovmr_tpu/ops/attention.py:28",
                kernel=lambda q=q, k=k, v=v: fused_attention(q, k, v),
                plain=lambda q=q, k=k, v=v: fused_attention_plain(q, k, v),
                library=lambda q=q, k=k, v=v: F.scaled_dot_product_attention(q, k, v),
                bytes=4 * q.numel() * q.element_size(),
                flops=4 * n * h * l * l * dh,
                peak=PEAK_FP32,  # K6 upcasts Q and K: its products are fp32 FMA
                reps=200, host_bound=True,
            ))

    vision_bwd_cases(torch, F, randn, check, params, layer, library_attn_half, library_mlp_half,
                     library_dx)
    gemm_cases(torch, randn, check)
    bwd_gemm_cases(torch, randn, check)
    bwd_core_cases(torch, F, randn, check)
    tp_cases(torch, F, randn, check, check_core, sliced, both)
    return results


def vision_bwd_cases(torch, F, randn, check, params, layer, library_attn_half,
                     library_mlp_half, library_dx):
    """K3 (no mask) at the vision towers' lengths, where it runs the
    query-tiled core: ViT-B/16 (197 x 768, 12 heads) and ViT-L/14@336px (577
    x 1024, 16 heads); K4 at K5's shape. bf16, at batches the plain twins
    hold at once. No serving or training path differentiates a vision tower;
    phase 11 does."""
    from ovmr_tpu_torch.ops.block_fused_bwd import (
        attn_half_bwd_dx,
        attn_half_bwd_dx_plain,
        mlp_half_bwd_dx,
        mlp_half_bwd_dx_plain,
    )

    for case, b, l, d, h, k4 in (("vision-bwd", 128, 197, 768, 12, False),
                                 ("vitl336-vision-bwd", 32, 577, 1024, 16, True)):
        p = {k: v.to(torch.bfloat16) for k, v in params.setdefault(d, layer(d)).items()}
        x, g = (randn(b, l, d).to(torch.bfloat16) for _ in range(2))
        tok, it = b * l, 2
        common = dict(case=case, dtype=torch.bfloat16, x=x, peak=PEAK_BF16, reps=5, rounds=3,
                      source="ovmr_tpu_torch/csrc/block_fused_bwd.cu")
        k3_args = (x, g, p["w_qkv"], p["b_qkv"], p["w_out"], p["ln_1_scale"], p["ln_1_bias"])
        check(dict(
            common, name="attn_half_bwd_dx", shape=[b, l, d, h],
            replaces="ovmr_tpu/ops/block_fused_bwd.py:128",
            kernel=lambda a=k3_args, h=h: attn_half_bwd_dx(*a, n_head=h),
            plain=lambda a=k3_args, h=h: attn_half_bwd_dx_plain(*a, n_head=h),
            library=lambda x=x, g=g, p=p, h=h: library_dx(library_attn_half, x, g, p, None, h),
            bytes=(3 * tok * d + 4 * d * d + 5 * d) * it,
            # the JAX cost estimate (ovmr_tpu/ops/block_fused_bwd.py:243)
            flops=16 * b * l * d * d + 10 * b * l * l * d,
        ))
        if not k4:
            continue
        k4_args = (x, g, p["c_fc_w"], p["c_fc_b"], p["c_proj_w"], p["ln_2_scale"],
                   p["ln_2_bias"])
        check(dict(
            common, name="mlp_half_bwd_dx", shape=[b, l, d, 4 * d],
            replaces="ovmr_tpu/ops/block_fused_bwd.py:57",
            kernel=lambda a=k4_args: mlp_half_bwd_dx(*a),
            plain=lambda a=k4_args: mlp_half_bwd_dx_plain(*a),
            library=lambda x=x, g=g, p=p: library_dx(library_mlp_half, x, g, p),
            bytes=(3 * tok * d + 8 * d * d + 6 * d) * it,
            flops=3 * 2 * tok * d * 4 * d,
        ))


def gemm_cases(torch, randn, check):
    """The wgmma/TMA GEMM alone at the products K5, K2, K1, K7 and K8 run on
    the serving paths, bf16: K5's per-chunk c_fc (QuickGELU, a column slice
    of c_fc_w read in place) and c_proj (added into the output) at
    ViT-L/14@336px and 512 images; K2's c_fc and c_proj (plus the residual)
    at ViT-B/16 and 512 images; K1's QKV (plus the bias) and out-proj (plus
    the bias and x), K7's q (plus the bias, into the first column slice of
    the shard's [tokens, 3 dl] buffer) and fp32 out-proj, and K8's c_fc
    (QuickGELU) and fp32 c_proj at ViT-L/14@336px and 512 images (K7, K8: a
    shard of model axis 2, dl 512, hidden 2048).
    Yardstick: torch.matmul of the same operands (no epilogue)."""
    from ovmr_tpu_torch.ops.block_fused import block_gemm, block_gemm_plain

    vitl = 512 * 577
    for case, m, n, k, ldw, ldc, epilogue, replaces in (
            ("vitl336-k5-c_fc", vitl, 2048, 1024, 4096, 2048, "gelu", "block_fused.py:249"),
            ("vitl336-k5-c_proj", vitl, 1024, 2048, 1024, 1024, "accum", "block_fused.py:249"),
            ("vision-k2-c_fc", 512 * 197, 3072, 768, 3072, 3072, "gelu", "block_fused.py:123"),
            ("vision-k2-c_proj", 512 * 197, 768, 3072, 768, 768, "residual",
             "block_fused.py:123"),
            ("vitl336-k1-qkv", vitl, 3072, 1024, 3072, 3072, "bias", "block_fused.py:58"),
            ("vitl336-k1-out", vitl, 1024, 1024, 1024, 1024, "residual", "block_fused.py:58"),
            ("vitl336-tp2-k7-q", vitl, 512, 1024, 512, 1536, "bias", "block_fused_tp.py:179"),
            ("vitl336-tp2-k7-out", vitl, 1024, 512, 1024, 1024, "f32",
             "block_fused_tp.py:179"),
            ("vitl336-tp2-k8-c_fc", vitl, 2048, 1024, 2048, 2048, "gelu",
             "block_fused_tp.py:245"),
            ("vitl336-tp2-k8-c_proj", vitl, 1024, 2048, 1024, 1024, "f32",
             "block_fused_tp.py:245")):
        a = randn(m, k).to(torch.bfloat16)
        w = randn(k, ldw, std=k ** -0.5).to(torch.bfloat16)[:, :n]
        bias = randn(n, std=0.02).to(torch.bfloat16) if epilogue not in ("accum", "f32") else None
        resid = randn(m, n).to(torch.bfloat16) if epilogue == "residual" else None
        c = randn(m, n).to(torch.bfloat16) if epilogue == "accum" else None
        # accum adds into its output: the kernel adds into a copy of c (its
        # first call is the one checked; each timed call adds once more);
        # K7's q lands in the first dl columns of a [tokens, 3 dl] buffer
        out = c.clone() if c is not None else None
        if ldc != n:
            out = torch.empty(m, ldc, dtype=torch.bfloat16, device="cuda")[:, :n]
        out_bytes = 4 if epilogue == "f32" else 2
        check(dict(
            name="gemm_wgmma", case=case, dtype=torch.bfloat16, shape=[m, n, k], x=a,
            key_shape=(m, n, k), source="ovmr_tpu_torch/csrc/gemm_wgmma.cuh",
            replaces="ovmr_tpu/ops/" + replaces,
            kernel=lambda a=a, w=w, b=bias, r=resid, o=out, e=epilogue: block_gemm(
                a, w, b, e, r, out=o),
            plain=lambda a=a, w=w, b=bias, r=resid, c=c, e=epilogue: block_gemm_plain(
                a, w, b, e, r, c),
            library=lambda a=a, w=w: torch.matmul(a, w),
            # A and W read, C written (and read by the accum epilogue), the
            # residual read, the bias read
            bytes=(m * k + k * n + (n if bias is not None else 0)) * 2 + m * n * out_bytes
            + (m * n * 2 if epilogue in ("accum", "residual") else 0),
            flops=2 * m * n * k, peak=PEAK_BF16, reps=10, rounds=5,
        ))


def bwd_gemm_cases(torch, randn, check):
    """The wgmma/TMA GEMM alone at the six products K3 and K4 run in the
    training step's text tower (192 prompts x 77 tokens, width 512, hidden
    2048), bf16: K3's QKV recompute (K1's launch, plus the bias), dattn = g
    @ w_out^T (cast), dxln = dqkv @ w_qkv^T (fp32, K = 1536); K4's h_pre =
    xln @ c_fc_w + c_fc_b (fp32), dh_pre = (g @ c_proj_w^T) QuickGELU'(h_pre)
    (cast) and dxln = dh_pre @ c_fc_w^T (fp32, K = 2048). The transposed
    weights are read as they are stored. Then K4's launch that runs: the
    c_fc recompute and the GELU' product in one (h_pre kept in registers).
    Yardstick: torch.matmul of the same operands (no epilogue)."""
    from ovmr_tpu_torch.ops.block_fused import block_gemm, block_gemm_plain
    from ovmr_tpu_torch.ops.block_fused_bwd import (
        block_gemm_bwd,
        block_gemm_bwd_plain,
        mlp_bwd_dh,
        mlp_bwd_dh_plain,
    )

    m, d, hidden = 192 * 77, 512, 2048
    for case, n, k, epilogue, replaces in (
            ("text-k3-qkv", 3 * d, d, "bias", "block_fused_bwd.py:219"),
            ("text-k3-dattn", d, d, "cast", "block_fused_bwd.py:219"),
            ("text-k3-dxln", d, 3 * d, "f32", "block_fused_bwd.py:219"),
            ("text-k4-h_pre", hidden, d, "bias_f32", "block_fused_bwd.py:57"),
            ("text-k4-dh_pre", hidden, d, "gelu_grad", "block_fused_bwd.py:57"),
            ("text-k4-dxln", d, hidden, "f32", "block_fused_bwd.py:57")):
        a = randn(m, k).to(torch.bfloat16)
        trans = epilogue in ("cast", "gelu_grad", "f32")
        w = randn(*((n, k) if trans else (k, n)), std=k ** -0.5).to(torch.bfloat16)
        bias = randn(n, std=0.02).to(torch.bfloat16) if epilogue in ("bias", "bias_f32") else None
        h_pre = randn(m, n) if epilogue == "gelu_grad" else None
        if epilogue == "bias":
            kernel = lambda a=a, w=w, b=bias: block_gemm(a, w, b, "bias")
            plain = lambda a=a, w=w, b=bias: block_gemm_plain(a, w, b, "bias")
        else:
            kernel = lambda a=a, w=w, b=bias, h=h_pre, e=epilogue: block_gemm_bwd(
                a, w, e, bias=b, h_pre=h)
            plain = lambda a=a, w=w, b=bias, h=h_pre, e=epilogue: block_gemm_bwd_plain(
                a, w, e, bias=b, h_pre=h)
        out_bytes = 4 if epilogue in ("f32", "bias_f32") else 2
        check(dict(
            name="gemm_wgmma", case=case, dtype=torch.bfloat16, shape=[m, n, k], x=a,
            key_shape=(m, n, k), source="ovmr_tpu_torch/csrc/gemm_wgmma.cuh",
            replaces="ovmr_tpu/ops/" + replaces, kernel=kernel, plain=plain,
            library=(lambda a=a, w=w: torch.matmul(a, w.t())) if trans
            else (lambda a=a, w=w: torch.matmul(a, w)),
            # A and W read, C written, the bias and the fp32 h_pre read
            bytes=(m * k + k * n + (n if bias is not None else 0)) * 2 + m * n * out_bytes
            + (m * n * 4 if h_pre is not None else 0),
            flops=2 * m * n * k, peak=PEAK_BF16, reps=10, rounds=5,
        ))
    xln, g = (randn(m, d).to(torch.bfloat16) for _ in range(2))
    c_fc_w = randn(d, hidden, std=d ** -0.5).to(torch.bfloat16)
    c_fc_b = randn(hidden, std=0.02).to(torch.bfloat16)
    c_proj_w = randn(hidden, d, std=hidden ** -0.5).to(torch.bfloat16)
    k4 = (xln, c_fc_w, c_fc_b, g, c_proj_w)
    check(dict(
        name="gemm_wgmma", case="text-k4-dh_pre-one-launch", dtype=torch.bfloat16,
        shape=[m, hidden, d], x=xln, key_shape=(m, hidden, d),
        source="ovmr_tpu_torch/csrc/gemm_wgmma.cuh", replaces="ovmr_tpu/ops/block_fused_bwd.py:57",
        kernel=lambda: mlp_bwd_dh(*k4), plain=lambda: mlp_bwd_dh_plain(*k4),
        library=lambda: (torch.matmul(xln, c_fc_w), torch.matmul(g, c_proj_w.t())),
        # xln, g and both weights read, the bias read, dh_pre written
        bytes=(2 * m * d + 2 * d * hidden + hidden + m * hidden) * 2,
        flops=2 * 2 * m * hidden * d, peak=PEAK_BF16, reps=10, rounds=5,
    ))


def bwd_core_cases(torch, F, randn, check):
    """K3's attention-backward core alone, bf16, on unit-variance q/k/v and
    cotangent: the one-launch core at the training step's text tower (192
    prompts x 77 tokens, width 512, 8 heads, causal) and the query-tiled
    pair at phase 11's ViT-L/14@336px vision blocks (32 images x 577
    tokens, width 1024, 16 heads). Yardstick: ``torch.autograd.grad``
    through SDPA on the same q/k/v and mask, with the same cotangent."""
    from ovmr_tpu_torch.ops.block_fused_bwd import attn_bwd_core, attn_bwd_core_plain
    from ovmr_tpu_torch.ops.layers import causal_mask

    for name, case, b, l, w, h, masked, replaces in (
            ("attn_bwd_core_short", "text-train", 192, 77, 512, 8, True,
             "ovmr_tpu/ops/block_fused_bwd.py:219"),
            ("attn_bwd_core_tiled", "vitl336-vision-bwd", 32, 577, 1024, 16, False,
             "ovmr_tpu/ops/block_fused_bwd.py:128")):
        qkv = randn(b, l, 3 * w).to(torch.bfloat16)
        dattn = randn(b, l, w).to(torch.bfloat16)
        mask = causal_mask(l, device="cuda") if masked else None
        lib_mask = None if mask is None else mask.to(torch.bfloat16)
        q, k, v = (t.detach().requires_grad_(True)
                   for t in qkv.view(b, l, 3, h, w // h).permute(2, 0, 3, 1, 4))
        do = dattn.view(b, l, h, w // h).transpose(1, 2)

        def library(q=q, k=k, v=v, do=do, m=lib_mask):
            with torch.enable_grad():
                o = F.scaled_dot_product_attention(q, k, v, attn_mask=m)
            return torch.autograd.grad(o, (q, k, v), do)

        pairs = l * (l + 1) // 2 if masked else l * l
        check(dict(
            name=name, case=case, dtype=torch.bfloat16, shape=[b, l, w, h], x=qkv,
            key_shape=(b, l, w, h), source="ovmr_tpu_torch/csrc/block_fused_bwd.cu",
            replaces=replaces,
            kernel=lambda qkv=qkv, d=dattn, m=mask, h=h: attn_bwd_core(qkv, d, m, h),
            plain=lambda qkv=qkv, d=dattn, m=mask, h=h: attn_bwd_core_plain(qkv, d, m, h),
            library=library,
            # qkv and dattn read, dqkv written (and the fp32 mask read);
            # q.k, dO.v, dS.k, dS^T.q and P^T.dO over the visible pairs
            bytes=7 * b * l * w * 2 + (l * l * 4 if masked else 0),
            flops=10 * b * pairs * w, peak=PEAK_BF16, reps=10, rounds=5,
        ))


def tp_cases(torch, F, randn, check, check_core, sliced, both):
    """K7 and K8 at the shard shapes of ViT-L/14@336px on a model axis of 2
    (vision: 8 heads, dl 512, hidden 2048; text: 6 heads, dl 384, hidden
    1536): the TP request's 512 exemplars and 32-prompt sets and the 256
    queries in bf16, the fp32 TP check's 4 images and 8 padded prompts in
    fp32; then a shard of zero-padded heads, which must give exact zeros."""
    from ovmr_tpu_torch.ops.block_fused_tp import (
        tp_attn_half_partial,
        tp_attn_half_partial_plain,
        tp_mlp_half_partial,
        tp_mlp_half_partial_plain,
    )
    from ovmr_tpu_torch.ops.layers import causal_mask

    def shard(d, dl, hl, zero_heads=False):
        z = 0.0 if zero_heads else 1.0
        return {
            "w_q": z * randn(d, dl, std=d ** -0.5), "b_q": z * randn(dl, std=0.02),
            "w_k": z * randn(d, dl, std=d ** -0.5), "b_k": z * randn(dl, std=0.02),
            "w_v": z * randn(d, dl, std=d ** -0.5), "b_v": z * randn(dl, std=0.02),
            "w_out": z * randn(dl, d, std=dl ** -0.5),
            "ln_1_scale": 1 + randn(d, std=0.1), "ln_1_bias": randn(d, std=0.1),
            "c_fc_w": randn(d, hl, std=d ** -0.5), "c_fc_b": randn(hl, std=0.02),
            "c_proj_w": randn(hl, d, std=hl ** -0.5),
            "ln_2_scale": 1 + randn(d, std=0.1), "ln_2_bias": randn(d, std=0.1),
        }

    def k7_args(x, s):
        return (x, s["w_q"], s["b_q"], s["w_k"], s["b_k"], s["w_v"], s["b_v"], s["w_out"],
                s["ln_1_scale"], s["ln_1_bias"])

    def library_k7(x, s, mask, nh):
        """F.layer_norm, three F.linear, SDPA, F.linear then cast to fp32."""
        b, l, d = x.shape
        dl = s["w_q"].shape[-1]
        xln = F.layer_norm(x, (d,), s["ln_1_scale"], s["ln_1_bias"])
        q, k, v = (F.linear(xln, s[w].t(), s[bias]).view(b, l, nh, dl // nh).transpose(1, 2)
                   for w, bias in (("w_q", "b_q"), ("w_k", "b_k"), ("w_v", "b_v")))
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        return F.linear(o.transpose(1, 2).reshape(b, l, dl), s["w_out"].t()).float()

    def library_k8(x, s):
        d = x.shape[-1]
        hdn = F.linear(F.layer_norm(x, (d,), s["ln_2_scale"], s["ln_2_bias"]),
                       s["c_fc_w"].t(), s["c_fc_b"])
        return F.linear(hdn * torch.sigmoid(1.702 * hdn), s["c_proj_w"].t()).float()

    bf16, fp32 = both[:1], both[1:]
    shards = {}
    for case, b, l, d, dl, nh, hl, masked, dtypes in (
            ("vitl336-tp2-vision-encode", 512, 577, 1024, 512, 8, 2048, False, bf16),
            ("vitl336-tp2-vision-classify", 256, 577, 1024, 512, 8, 2048, False, bf16),
            ("vitl336-tp2-text-prompts", 32, 77, 768, 384, 6, 1536, True, bf16),
            ("vitl336-tp2-vision-fp32", 4, 577, 1024, 512, 8, 2048, False, fp32),
            ("vitl336-tp2-text-fp32", 8, 77, 768, 384, 6, 1536, True, fp32)):
        s32 = shards.setdefault(d, shard(d, dl, hl))
        x32 = randn(b, l, d)
        mask = causal_mask(l, device="cuda") if masked else None
        step = 64 if b * nh * l * l * 4 > 2 ** 32 else b
        for dtype in dtypes:
            s = {k: v.to(dtype) for k, v in s32.items()}
            x = x32.to(dtype)
            it = x.element_size()
            tok = b * l
            pairs = l * (l + 1) // 2 if masked else l * l
            timing = dict(reps=10 if dtype == torch.bfloat16 and step == b else 3,
                          rounds=5 if step == b else 3)
            lib_mask = None if mask is None else mask.to(dtype)
            common = dict(case=case, dtype=dtype, x=x, source="ovmr_tpu_torch/csrc/block_fused.cu",
                          peak=PEAK_BF16 if dtype == torch.bfloat16 else PEAK_FP32, **timing)
            a = k7_args(x, s)
            check(dict(
                common,
                name="tp_attn_half_partial_masked" if masked else "tp_attn_half_partial",
                replaces=("ovmr_tpu/ops/block_fused_tp.py:235" if masked
                          else "ovmr_tpu/ops/block_fused_tp.py:179"),
                shape=[b, l, d, dl, nh], key_shape=(b, l, d, dl),
                kernel=lambda a=a, m=mask, nh=nh: tp_attn_half_partial(*a, mask=m, n_head=nh),
                plain=sliced(lambda xs, a=a, m=mask, nh=nh: tp_attn_half_partial_plain(
                    xs, *a[1:], mask=m, n_head=nh), x, step),
                library=sliced(lambda xs, s=s, m=lib_mask, nh=nh: library_k7(xs, s, m, nh),
                               x, step),
                # x read, the fp32 partial written, the shard's four weights,
                # three biases and LN1; q/k/v, scores, probs x V, out products
                bytes=tok * d * (it + 4) + (4 * d * dl + 3 * dl + 2 * d) * it
                + (l * l * 4 if masked else 0),
                flops=2 * tok * d * 3 * dl + 4 * b * pairs * dl + 2 * tok * dl * d,
            ))
            check_core(case, b, l, dl, nh, mask, dtype, "ovmr_tpu/ops/block_fused_tp.py:204",
                       timing)
            m8 = (x, s["c_fc_w"], s["c_fc_b"], s["c_proj_w"], s["ln_2_scale"], s["ln_2_bias"])
            check(dict(
                common, name="tp_mlp_half_partial", replaces="ovmr_tpu/ops/block_fused_tp.py:245",
                shape=[b, l, d, hl], key_shape=(b, l, d, hl),
                kernel=lambda m8=m8: tp_mlp_half_partial(*m8),
                plain=sliced(lambda xs, m8=m8: tp_mlp_half_partial_plain(xs, *m8[1:]), x, step),
                library=sliced(lambda xs, s=s: library_k8(xs, s), x, step),
                bytes=tok * d * (it + 4) + (2 * d * hl + hl + 2 * d) * it,
                flops=4 * tok * d * hl,
            ))
    # a shard of zero-padded heads (split_clip_qkv pads heads that do not
    # divide the model axis) contributes an exact zero, masked or not
    for l, d, dl, nh, masked in ((77, 768, 384, 6, True), (577, 1024, 512, 8, False)):
        s = shard(d, dl, 4 * d, zero_heads=True)
        x = randn(4, l, d)
        for dtype in both:
            mask = causal_mask(l, device="cuda") if masked else None
            a = k7_args(x.to(dtype), {k: v.to(dtype) for k, v in s.items()})
            got = tp_attn_half_partial(*a, mask=mask, n_head=nh)
            torch.cuda.synchronize()
            if not bool((got == 0).all()):
                raise AssertionError(f"K7 on a zero-padded shard ({l} x {d}, {dtype}): "
                                     f"max |out| {float(got.abs().max())}, expected exact zeros")
    print("[kernels] K7 on zero-padded head shards (77 x 768 causal, 577 x 1024; fp32, bf16): "
          "exact zeros", flush=True)


# ---------------------------------------------------------------------------
# phases 3 and 4: the serving slice
# ---------------------------------------------------------------------------

def exemplar_images(torch, n_cls, shots, seed, device, size=224):
    """Per-class base pattern plus per-shot noise, CLIP-normalized-like."""
    g = torch.Generator(device=device).manual_seed(seed)
    base = torch.randn(n_cls, 1, 3, size, size, generator=g, device=device)
    noise = torch.randn(n_cls, shots, 3, size, size, generator=g, device=device)
    return base + 0.5 * noise


def check_classifiers(np, out, n, d, n_ctx, unit_tol):
    for key in ("mm_classifier", "vision_classifier", "text_classifier"):
        v = out[key]
        assert v.shape == (n, d), (key, v.shape)
        assert np.isfinite(v).all(), key
        norms = np.linalg.norm(v, axis=-1)
        assert np.abs(norms - 1).max() < unit_tol, (key, norms)
    assert out["visual_tokens"].shape == (n, n_ctx, d)
    assert np.isfinite(out["visual_tokens"]).all()
    fw = out["fusion_weight"]
    assert fw.shape == (n, 3) and np.isfinite(fw).all()
    assert np.abs(fw.sum(-1) - 1).max() < 1e-5, fw.sum(-1)


VOCAB = ["golden retriever", "tabby cat", "sports car", "red panda", "fire truck",
         "bald eagle", "espresso", "lighthouse", "jellyfish", "pretzel", "volcano",
         "sunflower", "umbrella", "violin", "zebra", "airliner", "broccoli",
         "canoe", "dumbbell", "flamingo", "garden hose", "hamster", "iceberg",
         "jigsaw puzzle", "koala", "lemon", "mailbox", "necklace", "ostrich",
         "pineapple", "quill", "rocking chair", "snowmobile", "teapot",
         "unicycle", "vending machine", "waffle iron", "yurt", "crème brûlée",
         "Straße sign", "ski_mask", "T-Rex"]


N_CLS, SHOTS, N_QUERIES = 32, 16, 256


def make_requests(torch, count, size):
    """``count`` requests of N_CLS class names x SHOTS exemplars at ``size``
    px (seeds 100, 101, ...), and N_QUERIES query images (seed 200)."""
    requests = []
    for r in range(count):
        names = [VOCAB[(r * 7 + i) % len(VOCAB)] + ("" if r == 0 else f" {r}")
                 for i in range(N_CLS)]
        requests.append((names, exemplar_images(torch, N_CLS, SHOTS, 100 + r, "cuda", size)))
    return requests, exemplar_images(torch, N_QUERIES, 1, 200, "cuda", size)[:, 0]


def serving_slice(torch, np, tag, gen, n_requests, warmups=0):
    """``warmups`` uncounted requests, then with the launch counts zeroed:
    ``n_requests`` generate() calls of 32 classes x 16 exemplars at the
    model's resolution, classify() of 256 queries, export and reload.
    Checks the outputs and the exact launch counts by kernel and shape;
    prints the request split, peak memory and a profile of one request."""
    from ovmr_tpu_torch.api import load_exported_classifiers
    from ovmr_tpu_torch.models.ovmr import eval_logits_np
    from ovmr_tpu_torch.ops import cuda_lib
    from ovmr_tpu_torch.ops.block_fused import mlp_tier_chunks

    cfg = gen.clip_cfg
    size = cfg.image_resolution
    n_cls, shots, n_queries = N_CLS, SHOTS, N_QUERIES
    n_ctx = gen.agg_params["cls_token"].shape[0]
    requests, queries = make_requests(torch, warmups + n_requests, size)
    for names, images in requests[:warmups]:
        t = time.perf_counter()
        gen.generate(names, images)
        torch.cuda.synchronize()
        print(f"[{tag}] warm-up request: {(time.perf_counter() - t) * 1e3:.1f} ms wall",
              flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    cuda_lib.reset_launches()
    walls, outs = [], []
    for names, images in requests[warmups:]:
        t = time.perf_counter()
        out = gen.generate(names, images)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        outs.append(out)
    t = time.perf_counter()
    probs = gen.classify(queries, outs[-1], mode="fusion")
    classify_s = time.perf_counter() - t
    with tempfile.TemporaryDirectory() as tmp:
        gen.export(outs[-1], tmp)
        loaded = load_exported_classifiers(str(Path(tmp) / "mm_classifiers.pt"))
        vt = torch.load(str(Path(tmp) / "visual_tokens.pt"), weights_only=True)
    launches = dict(cuda_lib.LAUNCHES)
    shapes = dict(cuda_lib.LAUNCH_SHAPES)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    for i, wall in enumerate(walls):
        print(f"[{tag}] generate request {i}: {n_cls} classes x {shots} shots at {size} px, "
              f"{wall * 1e3:.1f} ms wall", flush=True)
    print(f"[{tag}] classify {n_queries} queries (fusion): {classify_s * 1e3:.1f} ms wall",
          flush=True)
    print(f"[{tag}] peak device memory over the requests and classify: {peak_gib:.2f} GiB",
          flush=True)
    print(f"[{tag}] launches during the slice: {launches}", flush=True)
    for key, count in sorted(shapes.items()):
        print(f"[{tag}]   {key[0]} {list(key[1])} {key[2]}: {count}", flush=True)
    for out in outs:
        check_classifiers(np, out, n_cls, cfg.embed_dim, n_ctx, unit_tol=1e-2)
    assert probs.shape == (n_queries, n_cls) and np.isfinite(probs).all()
    # fusion scores against the host-side numpy recipe on the same features
    scale = float(np.exp(gen.clip_params["logit_scale"].float().cpu().numpy()))
    host = eval_logits_np(gen.encode_images(queries), outs[-1], scale, "fusion")
    err = float(np.abs(probs - host).max())
    print(f"[{tag}] classify vs host recipe: max_abs_err {err:.3g} (tol 1e-5)", flush=True)
    assert err <= 1e-5, err
    assert set(loaded) == {"text_classifier", "vision_classifier", "mm_classifier",
                           "fusion_weight"}
    for key, v in loaded.items():
        assert v.dtype == np.float32 and np.array_equal(v, outs[-1][key]), key
    assert np.array_equal(vt["visual_tokens"].numpy(), outs[-1]["visual_tokens"])

    # per request: the vision tower's layers x (K1 + K2 or K5) for the 512
    # exemplars; the text tower's layers x (K1 causal + K2) for each of the
    # text, mm and v prompt sets; 4 x K6. classify: the vision tower once more.
    tokens, vw, tw = cfg.num_patches + 1, cfg.vision_width, cfg.transformer_width
    vision_mlp = ("fused_mlp_half_chunked" if mlp_tier_chunks(tokens, vw, 4 * vw)
                  else "fused_mlp_half")
    dt = str(gen.dtype).removeprefix("torch.")
    text_runs = n_requests * 3 * cfg.transformer_layers
    vh, th = cfg.vision_heads, cfg.transformer_heads
    want = {
        ("fused_attn_half", (n_cls * shots, tokens, vw), dt): n_requests * cfg.vision_layers,
        ("attn_core", (n_cls * shots, tokens, vw, vh), dt): n_requests * cfg.vision_layers,
        ("attn_core", (n_queries, tokens, vw, vh), dt): cfg.vision_layers,
        ("attn_core", (n_cls, cfg.context_length, tw, th), dt): text_runs,
        (vision_mlp, (n_cls * shots, tokens, vw), dt): n_requests * cfg.vision_layers,
        ("fused_attn_half", (n_queries, tokens, vw), dt): cfg.vision_layers,
        (vision_mlp, (n_queries, tokens, vw), dt): cfg.vision_layers,
        ("fused_attn_half_masked", (n_cls, cfg.context_length, tw), dt): text_runs,
        ("fused_mlp_half", (n_cls, cfg.context_length, tw), dt): text_runs,
        ("fused_attention", (n_cls, cfg.embed_dim // 64, shots + n_ctx, 64), dt): n_requests * 4,
    }
    if shapes != want:
        raise AssertionError(f"{tag}: launches by shape {shapes}, expected {want}")
    for kernel in {key[0] for key in want}:
        if launches[kernel] <= 0:
            raise AssertionError(f"kernel {kernel} was not launched on the {tag} path")
    # in bf16/fp16 every K1 and K2 runs two wgmma GEMMs and every K5 two a
    # chunk; in fp32 none
    chunks = mlp_tier_chunks(tokens, vw, 4 * vw)
    gemms = sum(n * (2 * chunks if key[0] == "fused_mlp_half_chunked" else 2)
                for key, n in want.items()
                if key[0].startswith(("fused_mlp_half", "fused_attn_half")))
    if gen.dtype == torch.float32:
        gemms = 0
    if launches["gemm_wgmma"] != gemms:
        raise AssertionError(f"{tag}: {launches['gemm_wgmma']} wgmma GEMM launches, "
                             f"expected {gemms}")

    # where a request's time goes: the exemplar encode vs the rest
    names, images = requests[0]
    t = time.perf_counter()
    feats = gen.encode_images(images.reshape(n_cls * shots, 3, size, size))
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t
    t = time.perf_counter()
    gen.generate_from_features(names, feats.reshape(n_cls, shots, -1))
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t
    print(f"[{tag}] request split: encode {enc_s * 1e3:.1f} ms, text + aggregator + "
          f"fusion {gen_s * 1e3:.1f} ms", flush=True)
    profile_call(torch, f"one {tag} request", lambda: gen.generate(names, images))
    return launches, shapes, outs


def device_times(torch, fn):
    """The wall milliseconds of one call of ``fn`` (to a synchronise) under
    torch.profiler, and the device's (ms, kernel name, launches) by kernel,
    largest first."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue  # host ops: their device time is their kernels' time
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us / 1e3, e.key, e.count))
    rows.sort(reverse=True)
    return wall_ms, rows


def profile_call(torch, what, fn):
    """Device time by kernel over one call of ``fn`` (torch.profiler), and
    the device's busy share of the call's wall time."""
    wall_ms, rows = device_times(torch, fn)
    busy_ms = sum(r[0] for r in rows)
    print(f"[profile] {what}: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%)", flush=True)
    for ms, key, count in rows[:8]:
        print(f"[profile]   {ms:8.2f} ms {100 * ms / busy_ms:5.1f}%  x{count:<4d} {key[:90]}",
              flush=True)


def fp32_path(torch, np, tag, make_gen, n_cls, shots, n_queries):
    """generate() + classify() at fp32 on the card (kernels) and on the CPU
    (plain versions), from ``make_gen(device)``: classifiers within 1e-4,
    fusion weights within 1e-3. Returns the CPU's (classifiers, scores)."""
    names = VOCAB[:n_cls]
    results = {}
    for device in ("cuda", "cpu"):
        gen = make_gen(device)
        size = gen.clip_cfg.image_resolution
        images = exemplar_images(torch, n_cls, shots, 300, "cpu", size)
        queries = exemplar_images(torch, n_queries, 1, 301, "cpu", size)[:, 0]
        t = time.perf_counter()
        out = gen.generate(names, images)
        probs = gen.classify(queries, out, mode="fusion")
        print(f"[{tag}] {device}: generate + classify {time.perf_counter() - t:.2f} s",
              flush=True)
        check_classifiers(np, out, n_cls, gen.clip_cfg.embed_dim, 2, unit_tol=1e-5)
        results[device] = (out, probs)
        del gen
    (gpu, gpu_p), (cpu, cpu_p) = results["cuda"], results["cpu"]
    hold_against(np, f"{tag} card vs CPU", gpu, cpu, gpu_p, cpu_p)
    return cpu, cpu_p


def hold_against(np, tag, got, ref, got_p, ref_p):
    """Classifiers within 1e-4, fusion weights within 1e-3, scores within 1e-4."""
    for key, tol in (("mm_classifier", 1e-4), ("vision_classifier", 1e-4),
                     ("text_classifier", 1e-4), ("visual_tokens", 1e-4),
                     ("fusion_weight", 1e-3)):
        err = float(np.abs(got[key] - ref[key]).max())
        print(f"[{tag}] {key}: max_abs_err {err:.3g} (tol {tol})", flush=True)
        if not err <= tol:
            raise AssertionError(f"{tag} {key}: differs by {err} > {tol}")
    err = float(np.abs(got_p - ref_p).max())
    print(f"[{tag}] classify(fusion): max_abs_err {err:.3g} (tol 1e-4)", flush=True)
    if not err <= 1e-4:
        raise AssertionError(f"{tag} classify: differs by {err}")


# ---------------------------------------------------------------------------
# phases 9 and 10: the serving slice on a model axis of 2
# ---------------------------------------------------------------------------

TP_SIZE = 2
# bf16 classifiers on the model axis against bf16 on one card: the sound
# runs read a cosine of 0.99986 at the least (PERF.md); a fault in the
# reduce or the bias placement falls below this
COSINE_FLOOR = 0.999


def tp_vision_launches(cfg, dtype, batch):
    """K7 and K8 once a shard in every vision layer, for ``batch`` images."""
    dt = str(dtype).removeprefix("torch.")
    vw, tokens = cfg.vision_width, cfg.num_patches + 1
    nh = -(-cfg.vision_heads // TP_SIZE)
    dl = vw // cfg.vision_heads * nh
    per = cfg.vision_layers * TP_SIZE
    return {("tp_attn_half_partial", (batch, tokens, vw, dl), dt): per,
            ("attn_core", (batch, tokens, dl, nh), dt): per,
            ("tp_mlp_half_partial", (batch, tokens, vw, 4 * vw // TP_SIZE), dt): per}


def tp_request_launches(cfg, dtype, n_cls, shots):
    """The launches of one request of ``n_cls`` x ``shots`` on the model
    axis: the exemplars' vision tower; the text tower for the text, mm and v
    prompt sets and K6 four times, at the class count padded to 8
    (``mm_generate_classifiers``' class_pad_multiple)."""
    from ovmr_tpu_torch.parallel.mesh import pad_to_multiple

    dt = str(dtype).removeprefix("torch.")
    tw, n = cfg.transformer_width, pad_to_multiple(n_cls, 8)
    nh = -(-cfg.transformer_heads // TP_SIZE)
    dl = tw // cfg.transformer_heads * nh
    per = 3 * cfg.transformer_layers * TP_SIZE
    return {
        **tp_vision_launches(cfg, dtype, n_cls * shots),
        ("tp_attn_half_partial_masked", (n, cfg.context_length, tw, dl), dt): per,
        ("attn_core", (n, cfg.context_length, dl, nh), dt): per,
        ("tp_mlp_half_partial", (n, cfg.context_length, tw, 4 * tw // TP_SIZE), dt): per,
        ("fused_attention", (n, cfg.embed_dim // 64, shots + 2, 64), dt): 4,
    }


def tp_server(torch, gen):
    """The MM_CLS_OP serving seams over ``gen``'s towers on a model axis of
    TP_SIZE local shards: ``request(names, images) -> classifiers``,
    ``classify(images, classifiers) -> fusion scores`` and ``encode(images)
    -> features``, each batch encoded at its own size."""
    from ovmr_tpu_torch.engine.trainer import (
        make_feature_extractor,
        mm_generate_classifiers,
        tp_seam_tools,
    )
    from ovmr_tpu_torch.models.ovmr import build_prompt_tokens, eval_logits
    from ovmr_tpu_torch.ops.preprocess import CLIP_MEAN, CLIP_STD
    from ovmr_tpu_torch.parallel import ModelAxis

    cfg = gen.clip_cfg
    t = time.perf_counter()
    block, params = tp_seam_tools(ModelAxis.local(TP_SIZE), gen.clip_params, cfg)
    torch.cuda.synchronize()
    print(f"[tp] towers split and placed as {TP_SIZE} local shards in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    encoders = {}

    def encode(images):
        n = images.shape[0]
        if n not in encoders:
            encoders[n] = make_feature_extractor(cfg, gen.dtype, CLIP_MEAN, CLIP_STD, batch_size=n,
                                                 device="cuda", tp_block_fn=block)
        return encoders[n](params, images)

    def request(names, images):
        n, k = images.shape[:2]
        feats = encode(images.reshape(n * k, *images.shape[2:])).reshape(n, k, -1)
        ptok, eot, vtok = build_prompt_tokens(names)
        return mm_generate_classifiers(params, cfg, gen.agg_params, feats, ptok, eot, vtok,
                                       eval_tau=10.0, block_fn=block)

    def classify(images, classifiers):
        feats = torch.as_tensor(encode(images), device="cuda")
        dev = {k: torch.as_tensor(v, device="cuda") for k, v in classifiers.items()}
        scale = float(params["logit_scale"].float().exp())
        return eval_logits(feats, dev, scale, "fusion").cpu().numpy()

    return request, classify, encode


def tp_serving_slice(torch, np, gen, single_outs, n_requests=2, warmups=1):
    """ViT-L/14@336px bf16 on TP_SIZE local shards: ``warmups`` uncounted
    requests, then ``n_requests`` requests of 32 x 16 and 256 queries, each
    with exact launch counts by kernel and shape; the classifiers held
    against the single-card ones of the same requests (``single_outs``) by
    the cosine floor; the request split and a profile."""
    from ovmr_tpu_torch.models.ovmr import eval_logits_np
    from ovmr_tpu_torch.ops import cuda_lib

    cfg = gen.clip_cfg
    size = cfg.image_resolution
    request, classify, encode = tp_server(torch, gen)
    requests, queries = make_requests(torch, warmups + n_requests, size)
    for names, images in requests[:warmups]:
        t = time.perf_counter()
        request(names, images)
        torch.cuda.synchronize()
        print(f"[tp] warm-up request: {(time.perf_counter() - t) * 1e3:.1f} ms wall", flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    want_request = tp_request_launches(cfg, gen.dtype, N_CLS, SHOTS)
    launches, shapes, outs, walls = {k: 0 for k in cuda_lib.LAUNCHES}, {}, [], []

    def counted(want, fn):
        cuda_lib.reset_launches()
        out = fn()
        got = dict(cuda_lib.LAUNCH_SHAPES)
        if got != want:
            raise AssertionError(f"tp: launches by shape {got}, expected {want}")
        for key, n in cuda_lib.LAUNCHES.items():
            launches[key] += n
        for key, n in got.items():
            shapes[key] = shapes.get(key, 0) + n
        return out

    for names, images in requests[warmups:]:
        t = time.perf_counter()
        outs.append(counted(want_request, lambda: request(names, images)))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    t = time.perf_counter()
    probs = counted(tp_vision_launches(cfg, gen.dtype, N_QUERIES),
                    lambda: classify(queries, outs[-1]))
    classify_s = time.perf_counter() - t
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    for i, wall in enumerate(walls):
        print(f"[tp] request {i}: {N_CLS} classes x {SHOTS} shots at {size} px, model axis "
              f"{TP_SIZE}, {wall * 1e3:.1f} ms wall", flush=True)
    print(f"[tp] classify {N_QUERIES} queries (fusion): {classify_s * 1e3:.1f} ms wall",
          flush=True)
    print(f"[tp] peak device memory over the requests and classify: {peak_gib:.2f} GiB",
          flush=True)
    print(f"[tp] launches per request, exact: {want_request}", flush=True)
    for name in ("fused_attn_half", "fused_attn_half_masked", "fused_mlp_half",
                 "fused_mlp_half_chunked"):
        assert launches[name] == 0, (name, launches[name])
    # in bf16/fp16 every K7 runs its q, k, v and out-proj on the wgmma GEMM,
    # every K8 its c_fc and c_proj
    k7 = sum(n for key, n in shapes.items() if key[0].startswith("tp_attn_half_partial"))
    k8 = sum(n for key, n in shapes.items() if key[0] == "tp_mlp_half_partial")
    if launches["gemm_wgmma"] != 4 * k7 + 2 * k8:
        raise AssertionError(f"tp: {launches['gemm_wgmma']} wgmma GEMM launches, "
                             f"expected 4 x {k7} K7 + 2 x {k8} K8")
    for out in outs:
        check_classifiers(np, out, N_CLS, cfg.embed_dim, 2, unit_tol=1e-2)
    assert probs.shape == (N_QUERIES, N_CLS) and np.isfinite(probs).all()
    host = eval_logits_np(encode(queries), outs[-1],
                          float(np.exp(gen.clip_params["logit_scale"].float().cpu().numpy())),
                          "fusion")
    err = float(np.abs(probs - host).max())
    print(f"[tp] classify vs host recipe: max_abs_err {err:.3g} (tol 1e-5)", flush=True)
    assert err <= 1e-5, err
    # bf16 on a model axis against bf16 on one card, request by request:
    # the same function rounded at other places (fp32 partial sums)
    for i, (tp_out, one) in enumerate(zip(outs, single_outs)):
        for key in ("mm_classifier", "vision_classifier", "text_classifier", "visual_tokens"):
            a = tp_out[key].reshape(N_CLS, -1).astype(np.float64)
            b = one[key].reshape(N_CLS, -1).astype(np.float64)
            cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))
            print(f"[tp] request {i} {key} vs one card: cosine min {cos.min():.6f}, mean "
                  f"{cos.mean():.6f} (floor {COSINE_FLOOR})", flush=True)
            if not cos.min() >= COSINE_FLOOR:
                raise AssertionError(f"tp request {i} {key}: cosine {cos.min()} to the "
                                     f"single-card classifiers, below {COSINE_FLOOR}")

    names, images = requests[warmups]
    t = time.perf_counter()
    encode(images.reshape(N_CLS * SHOTS, 3, size, size))
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t
    t = time.perf_counter()
    request(names, images)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t
    print(f"[tp] request split: encode {enc_s * 1e3:.1f} ms, text + aggregator + fusion "
          f"{(total_s - enc_s) * 1e3:.1f} ms (of {total_s * 1e3:.1f} ms)", flush=True)
    profile_call(torch, "one tp request", lambda: request(names, images))
    return launches, shapes


def tp_fp32_check(torch, np, gen, cpu_out, cpu_probs, n_cls=2, shots=2, n_queries=4):
    """Phase 8's fp32 request and queries (same seeds) on TP_SIZE local
    shards on the card, against phase 8's CPU single-device result."""
    from ovmr_tpu_torch.ops import cuda_lib

    size = gen.clip_cfg.image_resolution
    request, classify, _ = tp_server(torch, gen)
    images = exemplar_images(torch, n_cls, shots, 300, "cpu", size)
    queries = exemplar_images(torch, n_queries, 1, 301, "cpu", size)[:, 0]
    cuda_lib.reset_launches()
    t = time.perf_counter()
    out = request(VOCAB[:n_cls], images)
    probs = classify(queries, out)
    print(f"[tp-fp32] cuda: generate + classify {time.perf_counter() - t:.2f} s", flush=True)
    shapes = dict(cuda_lib.LAUNCH_SHAPES)
    print(f"[tp-fp32] launches by shape: {shapes}", flush=True)
    want = tp_request_launches(gen.clip_cfg, gen.dtype, n_cls, shots)
    for key, n in tp_vision_launches(gen.clip_cfg, gen.dtype, n_queries).items():
        want[key] = want.get(key, 0) + n
    if shapes != want:
        raise AssertionError(f"tp-fp32: launches by shape {shapes}, expected {want}")
    check_classifiers(np, out, n_cls, gen.clip_cfg.embed_dim, 2, unit_tol=1e-5)
    hold_against(np, "tp-fp32 card vs CPU single device", out, cpu_out, probs, cpu_probs)
    return shapes


# ---------------------------------------------------------------------------
# phases 5 and 6: the training slice
# ---------------------------------------------------------------------------

class FlagshipOptim:
    """The OPTIM settings of the flagship recipe
    (configs/trainers/MM_CLS_OP/vit_b16_c4_ep50_imagenet21k_pretrain.yaml
    over the defaults)."""
    NAME = "adam"
    LR = 2e-4
    WEIGHT_DECAY = 5e-4
    MOMENTUM = 0.9
    SGD_NESTEROV = False
    RMSPROP_ALPHA = 0.99
    ADAM_BETA1 = 0.9
    ADAM_BETA2 = 0.999
    STAGED_LR = False
    MAX_EPOCH = 30
    LR_SCHEDULER = "cosine"
    STEPSIZE = (-1,)
    GAMMA = 0.1
    WARMUP_EPOCH = 1
    WARMUP_TYPE = "constant"
    WARMUP_CONS_LR = 1e-5
    WARMUP_MIN_LR = 1e-5
    WARMUP_RECOUNT = True


def trainable_aggregator(torch, agg_params, device):
    """A fresh copy of the aggregator on ``device`` whose leaves train."""
    def leaf(t):
        return t.detach().clone().to(device).requires_grad_(True)

    return {"blocks": {k: leaf(v) for k, v in agg_params["blocks"].items()},
            "cls_token": leaf(agg_params["cls_token"])}


def prompt_inputs(torch, np, n_cls, device):
    from ovmr_tpu_torch.models.ovmr import build_prompt_tokens

    nouns = ["retriever", "cat", "car", "panda", "truck", "eagle", "espresso", "lighthouse",
             "jellyfish", "pretzel", "volcano", "sunflower", "umbrella", "violin", "zebra",
             "airliner"]
    adjectives = ["golden", "tabby", "red", "small", "old", "bald", "striped", "tall",
                  "wild", "salty", "quiet", "bright"]
    names = [f"{adjectives[i % len(adjectives)]} {nouns[i % len(nouns)]} {i}"
             for i in range(n_cls)]
    ptok, eot, vtok = build_prompt_tokens(names)
    return tuple(torch.as_tensor(np.asarray(a), device=device) for a in (ptok, eot, vtok))


def train_step_launches(cfg):
    """Exact launches of one bf16 training step at dropout 0.1, by kernel."""
    layers = cfg.transformer_layers
    return {
        "fused_attn_half": 2 * cfg.vision_layers,   # two image passes
        "fused_attn_half_masked": 2 * layers,       # the mm and v prompt sets
        "attn_core": 2 * cfg.vision_layers + 2 * layers,  # inside each K1
        "fused_mlp_half": 2 * cfg.vision_layers + 2 * layers,
        "fused_mlp_half_chunked": 0,                # ViT-B/16's MLP weights stay resident
        "attn_half_bwd_dx_masked": 2 * layers,
        "mlp_half_bwd_dx": 2 * layers,
        "attn_half_bwd_dx": 0,
        "fused_attention": 0,                       # dropout expands the attention
        "tp_attn_half_partial": 0,                  # no model axis
        "tp_attn_half_partial_masked": 0,
        "tp_mlp_half_partial": 0,
        # two inside each K1 and K2, three inside each K3, two inside each K4
        "gemm_wgmma": 4 * (2 * cfg.vision_layers + 2 * layers) + 5 * 2 * layers,
        "attn_bwd_core_short": 2 * layers,          # every K3: the text tower's 77 tokens
        "attn_bwd_core_tiled": 0,
    }


def training_slice(torch, np, clip_params, agg_params):
    from ovmr_tpu_torch.engine.optimizers import build_optimizer, param_leaves, set_lr
    from ovmr_tpu_torch.engine.schedule import lr_schedule_from_cfg
    from ovmr_tpu_torch.engine.train_step import (
        classifier_loss,
        frozen_features,
        make_train_step,
    )
    from ovmr_tpu_torch.models import clip as tclip
    from ovmr_tpu_torch.ops import cuda_lib

    cfg = tclip.VIT_B16
    n_cls, n_ins, dropout = 192, 8, 0.1
    splits = (4, 4, 3, 5)  # the warm-up step, then the three timed ones
    towers = tclip.cast_params(tclip.tree_to(clip_params, device="cuda"), torch.bfloat16)
    images = exemplar_images(torch, n_cls, n_ins, 400, "cuda")
    ptok, eot, vtok = prompt_inputs(torch, np, n_cls, "cuda")
    lr = lr_schedule_from_cfg(FlagshipOptim)[1]  # the first epoch after the warm-up: 2e-4
    step_fn = make_train_step(cfg, dropout=dropout)
    expected = train_step_launches(cfg)

    def fresh():
        agg = trainable_aggregator(torch, agg_params, "cuda")
        optimizer = set_lr(build_optimizer(FlagshipOptim, agg), lr)
        return agg, optimizer, torch.Generator(device="cuda").manual_seed(7)

    # run A: the step as a user calls it, launch counts read per step
    agg, optimizer, gen = fresh()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches, shapes, losses, walls = {k: 0 for k in cuda_lib.LAUNCHES}, {}, [], []
    for i, split in enumerate(splits):
        before = [leaf.detach().clone() for leaf in param_leaves(agg)]
        cuda_lib.reset_launches()
        t = time.perf_counter()
        loss = step_fn(agg, optimizer, towers, images, ptok, eot, vtok, gen, split)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        losses.append(float(loss))
        got = dict(cuda_lib.LAUNCHES)
        if got != expected:
            raise AssertionError(f"train step {i}: launches {got}, expected {expected}")
        if not math.isfinite(losses[-1]):
            raise AssertionError(f"train step {i}: loss {losses[-1]}")
        if i == 0:
            for name, leaf, old in zip(leaf_names(agg), param_leaves(agg), before):
                g = leaf.grad
                if g is None or not bool(torch.isfinite(g).all()) or float(g.abs().max()) == 0:
                    raise AssertionError(f"train step 0: no finite non-zero gradient for {name}")
                if torch.equal(leaf.detach(), old):
                    raise AssertionError(f"train step 0: {name} did not change")
        else:  # the timed steps are the main path's run
            for key, n in got.items():
                launches[key] += n
            for key, n in cuda_lib.LAUNCH_SHAPES.items():
                shapes[key] = shapes.get(key, 0) + n
        tag = "warm-up" if i == 0 else f"timed {i}"
        print(f"[train] step {i} ({tag}): {n_cls} classes x {n_ins} instances, split {split}, "
              f"loss {losses[-1]:.4f}, {walls[-1] * 1e3:.1f} ms wall", flush=True)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[train] launches per step: {expected}; peak memory {peak_gib:.2f} GiB", flush=True)
    for key, count in sorted(shapes.items()):
        print(f"[train]   {key[0]} {list(key[1])} {key[2]}: {count}", flush=True)

    # run B: the same seeds, the step taken apart and timed part by part
    agg, optimizer, gen = fresh()
    for i, split in enumerate(splits):
        parts = []

        def timed(fn):
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            parts.append((time.perf_counter() - t) * 1e3)
            return out

        frozen = timed(lambda: frozen_features(towers, cfg, images, ptok, vtok, split))
        optimizer.zero_grad(set_to_none=True)
        loss = timed(lambda: classifier_loss(towers, cfg, agg, frozen, eot, dropout=dropout,
                                             generator=gen))
        timed(loss.backward)
        timed(optimizer.step)
        print(f"[train] step {i} split: image passes {parts[0]:.1f} ms, heads forward "
              f"{parts[1]:.1f} ms, backward {parts[2]:.1f} ms, optimizer {parts[3]:.1f} ms",
              flush=True)
        if float(loss.detach()) != losses[i]:
            raise AssertionError(f"train step {i}: loss {float(loss.detach())!r} in the second run, "
                                 f"{losses[i]!r} in the first, from the same seeds")
    print("[train] two runs from the same seeds gave the same losses", flush=True)
    profile_call(torch, "one train step", lambda: step_fn(
        agg, optimizer, towers, images, ptok, eot, vtok, gen, 4))
    return launches, shapes


def leaf_names(agg):
    """Names in ``param_leaves`` order (sorted keys, depth first)."""
    return [f"blocks.{k}" for k in sorted(agg["blocks"])] + ["cls_token"]


def fp32_train_step(torch, np, clip_params, agg_params):
    from ovmr_tpu_torch.engine.optimizers import build_optimizer, param_leaves
    from ovmr_tpu_torch.engine.train_step import make_train_step
    from ovmr_tpu_torch.models import clip as tclip
    from ovmr_tpu_torch.ops import cuda_lib

    cfg = tclip.VIT_B16
    images = exemplar_images(torch, 4, 4, 500, "cpu")
    step_fn = make_train_step(cfg, dropout=0.0)
    results = {}
    for device in ("cuda", "cpu"):
        towers = tclip.tree_to(clip_params, device=device)
        agg = trainable_aggregator(torch, agg_params, device)
        optimizer = build_optimizer(FlagshipOptim, agg)
        ptok, eot, vtok = prompt_inputs(torch, np, 4, device)
        cuda_lib.reset_launches()
        t = time.perf_counter()
        loss = step_fn(agg, optimizer, towers, images.to(device), ptok, eot, vtok, None, 2)
        print(f"[fp32-train] {device}: one step {time.perf_counter() - t:.2f} s, "
              f"loss {float(loss):.6f}", flush=True)
        if device == "cuda":
            got = dict(cuda_lib.LAUNCHES)
            want = {"fused_attn_half": 24, "fused_attn_half_masked": 24, "attn_core": 48,
                    "fused_mlp_half": 48,
                    "fused_mlp_half_chunked": 0, "attn_half_bwd_dx_masked": 24, "mlp_half_bwd_dx": 24,
                    "attn_half_bwd_dx": 0, "fused_attention": 4, "tp_attn_half_partial": 0,
                    "tp_attn_half_partial_masked": 0, "tp_mlp_half_partial": 0,
                    "gemm_wgmma": 0, "attn_bwd_core_short": 0, "attn_bwd_core_tiled": 24}
            if got != want:
                raise AssertionError(f"fp32 train step: launches {got}, expected {want}")
        results[device] = (
            float(loss), [leaf.grad.cpu() for leaf in param_leaves(agg)],
            [leaf.detach().cpu() for leaf in param_leaves(agg)],
        )
    (g_loss, g_grads, g_params), (c_loss, c_grads, c_params) = results["cuda"], results["cpu"]
    print(f"[fp32-train] card vs CPU loss: {abs(g_loss - c_loss):.3g} (tol 1e-4)", flush=True)
    if not abs(g_loss - c_loss) <= 1e-4:
        raise AssertionError(f"fp32 train step: loss {g_loss} on the card, {c_loss} on the CPU")
    # Adam's first step is lr * g / (|g| + 1e-8) with g the gradient plus the
    # L2 decay term: where that sum is rounding noise (the key bias, whose
    # gradient is zero in exact arithmetic; weights whose gradient cancels
    # the decay) rounding decides what share of lr the element moves, up to a
    # full step each way. So the parameters are held as the nine-step
    # trajectory test holds them: the bulk tightly (median 1e-6, mean 1e-5),
    # the tail by Adam's bound of 2 x lr.
    lr = FlagshipOptim.LR
    worst_g = worst_p = 0.0
    for name, gg, cg, gp, cp in zip(leaf_names(agg), g_grads, c_grads, g_params, c_params):
        scale = max(float(cg.abs().max()), 1e-12)
        rel = float((gg - cg).abs().max()) / scale
        diff = (gp - cp).abs().flatten()
        median, mean, top = float(diff.median()), float(diff.mean()), float(diff.max())
        worst_g, worst_p = max(worst_g, rel), max(worst_p, mean)
        print(f"[fp32-train]   {name}: grad err / scale {rel:.3g}; post-step param err median "
              f"{median:.3g}, mean {mean:.3g}, max {top:.3g}", flush=True)
        if not rel <= 1e-4:
            raise AssertionError(f"fp32 train step: gradient of {name} differs by {rel} of its "
                                 "scale between the card and the CPU (tol 1e-4)")
        if not (median <= 1e-6 and mean <= 1e-5 and top <= 2 * lr * 1.001):
            raise AssertionError(
                f"fp32 train step: {name} differs after the update by median {median}, mean "
                f"{mean}, max {top} (tol 1e-6, 1e-5, {2 * lr})")
    print(f"[fp32-train] card vs CPU: gradients within {worst_g:.3g} of their scale (tol 1e-4), "
          f"post-step params within {worst_p:.3g} on average (tol 1e-5)", flush=True)


def vision_backward(torch):
    """Phase 11: loss.backward() through two ViT-L/14@336px vision blocks
    (577 x 1024, 16 heads, hidden 4096; seeded random layers, 2 images): K1
    and K5 forward, K4 and K3 (its query-tiled core) backward, with exact
    launch counts. fp32 on the card against the CPU (the plain twins): dx
    within 1e-4 of its scale; bf16 on the card: a finite dx."""
    from ovmr_tpu_torch.ops import cuda_lib
    from ovmr_tpu_torch.ops.block_fused import BLOCK_KEYS, fused_residual_block, mlp_tier_chunks

    b, l, d, h = 2, 577, 1024, 16
    chunks = mlp_tier_chunks(l, d, 4 * d)
    gen = torch.Generator().manual_seed(11)

    def r(*shape, std=1.0):
        return torch.randn(*shape, generator=gen) * std

    shapes = {"w_qkv": ((d, 3 * d), d ** -0.5), "b_qkv": ((3 * d,), 0.02),
              "w_out": ((d, d), d ** -0.5), "b_out": ((d,), 0.02),
              "ln_1_scale": ((d,), 0.1), "ln_1_bias": ((d,), 0.1),
              "c_fc_w": ((d, 4 * d), d ** -0.5), "c_fc_b": ((4 * d,), 0.02),
              "c_proj_w": ((4 * d, d), (4 * d) ** -0.5), "c_proj_b": ((d,), 0.02),
              "ln_2_scale": ((d,), 0.1), "ln_2_bias": ((d,), 0.1)}
    layers = [{k: r(*shape, std=std) + (1.0 if k.endswith("_scale") else 0.0)
               for k, (shape, std) in shapes.items()} for _ in range(2)]
    assert set(layers[0]) == set(BLOCK_KEYS)
    x0, g0 = r(b, l, d), r(b, l, d)
    grads = {}
    for device, dtype in (("cuda", torch.float32), ("cpu", torch.float32),
                          ("cuda", torch.bfloat16)):
        ps = [{k: v.to(device, dtype) for k, v in p.items()} for p in layers]
        x = x0.to(device, dtype, copy=True).requires_grad_(True)
        cuda_lib.reset_launches()
        t = time.perf_counter()
        y = x
        for p in ps:
            y = fused_residual_block(y, p, h)
        y.backward(g0.to(device, dtype))
        if device == "cuda":
            torch.cuda.synchronize()
            want = {k: 0 for k in cuda_lib.LAUNCHES}
            # bf16: K1 two GEMMs, K5 two a chunk, K4 two, K3 three
            want.update(fused_attn_half=2, attn_core=2, fused_mlp_half_chunked=2,
                        mlp_half_bwd_dx=2, attn_half_bwd_dx=2, attn_bwd_core_tiled=2,
                        gemm_wgmma=0 if dtype == torch.float32 else 2 * (2 + 2 * chunks + 5))
            if dict(cuda_lib.LAUNCHES) != want:
                raise AssertionError(f"vision backward ({dtype}): launches "
                                     f"{dict(cuda_lib.LAUNCHES)}, expected {want}")
        dx = x.grad.float().cpu()
        tag = f"{device} {str(dtype).removeprefix('torch.')}"
        print(f"[vision-bwd] {tag}: two ViT-L/14@336px vision blocks forward + backward, "
              f"{b} x {l} x {d}: {time.perf_counter() - t:.2f} s, |dx| max "
              f"{float(dx.abs().max()):.4g}", flush=True)
        if not bool(torch.isfinite(dx).all()):
            raise AssertionError(f"vision backward ({tag}): dx is not finite")
        grads[tag] = dx
    ref = grads["cpu float32"]
    scale = max(float(ref.abs().max()), 1.0)
    err = float((grads["cuda float32"] - ref).abs().max())
    print(f"[vision-bwd] fp32 card vs CPU: dx max_abs_err {err:.3g} (tol {1e-4 * scale:.3g}, "
          "1e-4 of its scale)", flush=True)
    if not err <= 1e-4 * scale:
        raise AssertionError(f"vision backward: fp32 dx differs by {err} between card and CPU")


# ---------------------------------------------------------------------------
# phase 12: the MM_CLS_OP trainer through its entry point
# ---------------------------------------------------------------------------

# the flagship recipe of
# configs/trainers/MM_CLS_OP/vit_b16_c4_ep50_imagenet21k_pretrain.yaml, as
# command-line options over the defaults (no yaml is read)
FLAGSHIP_TRANSFORMS = ["random_resized_crop", "random_flip", "colorjitter", "gaussian_noise",
                       "normalize"]
FLAGSHIP_OPTS = [
    "MODEL.BACKBONE.NAME", "ViT-B/16", "INPUT.SIZE", "(224, 224)",
    "INPUT.INTERPOLATION", "bicubic",
    "INPUT.PIXEL_MEAN", "[0.48145466, 0.4578275, 0.40821073]",
    "INPUT.PIXEL_STD", "[0.26862954, 0.26130258, 0.27577711]",
    "INPUT.RRCROP_SCALE", "(0.25, 1.0)",
    "DATALOADER.TRAIN_X.SAMPLER", "RandomClassSampler", "DATALOADER.TRAIN_X.BATCH_SIZE", "1536",
    "DATALOADER.TRAIN_X.N_INS", "8", "DATALOADER.TEST.BATCH_SIZE", "256",
    "DATALOADER.TEST.N_INS", "16", "DATALOADER.NUM_WORKERS", "8", "DATALOADER.K_TRANSFORMS", "1",
    "OPTIM.NAME", "adam", "OPTIM.LR", "0.0002", "OPTIM.LR_SCHEDULER", "cosine",
    "OPTIM.WARMUP_EPOCH", "1", "OPTIM.WARMUP_TYPE", "constant", "OPTIM.WARMUP_CONS_LR", "1e-5",
    "TRAINER.COCOOP.CTX_INIT", "' ?'", "TRAINER.COCOOP.PREC", "fp16",
    "CUDA.DTYPE", "bfloat16", "CUDA.DEVICE", "cuda",
]
TRAINER_CLASSES, TRAINER_SHOTS = 192, 8


class Recorder:
    """Wraps trainer methods at the class level for one phase: times each
    call to a device synchronise, and keeps per-call notes."""

    def __init__(self, torch):
        self.torch = torch
        self.saved = []
        self.times = {}

    def wrap(self, owner, name, before=None, after=None):
        orig = getattr(owner, name)
        torch = self.torch

        def wrapper(*args, **kwargs):
            if before is not None:
                before(*args)
            t = time.perf_counter()
            out = orig(*args, **kwargs)
            torch.cuda.synchronize()
            self.times.setdefault(name, []).append(time.perf_counter() - t)
            if after is not None:
                after(*args, out=out)
            return out

        self.saved.append((owner, name, orig))
        setattr(owner, name, wrapper)

    def restore(self):
        for owner, name, orig in reversed(self.saved):
            setattr(owner, name, orig)


def run_entry(parser, entry, argv):
    """``python -m ovmr_tpu_torch.train ARGV`` in this process; its log tee
    is closed and stdout restored after it."""
    stdout = sys.stdout
    try:
        return entry.main(parser.parse_args(argv))
    finally:
        tee, sys.stdout = sys.stdout, stdout
        if tee is not stdout:
            tee.close()


def trainer_phase(torch, np):
    """Phase 12: MM_CLS_OP through ``ovmr_tpu_torch.train.main`` on the card
    at ViT-B/16, bf16, the flagship recipe, over Synthetic (192 classes x 16
    images at 224 px, 8 shots): train 2 epochs, resume to 3, then the
    fusion eval. Returns the launches and launches by shape over the three
    runs."""
    import importlib.util
    import os

    from ovmr_tpu_torch import train as entry
    from ovmr_tpu_torch.engine import checkpoint as ckpt
    from ovmr_tpu_torch.engine import trainer as trainer_mod
    from ovmr_tpu_torch.models import clip as tclip
    from ovmr_tpu_torch.ops import cuda_lib

    cfg = tclip.VIT_B16
    have_pil = importlib.util.find_spec("PIL") is not None
    choices = FLAGSHIP_TRANSFORMS if have_pil else ["random_flip", "normalize"]
    print(f"[trainer] PIL {'is' if have_pil else 'is not'} installed: train transforms "
          f"{choices}", flush=True)
    work = Path(tempfile.mkdtemp(prefix="ovmr_trainer_smoke_"))  # removed at the end
    os.environ["OVMR_SYNTHETIC"] = f"{TRAINER_CLASSES},16,224"
    out, eval_out = work / "train_out", work / "eval_out"
    common = ["--root", str(work / "data"), "--seed", "1", "--trainer", "MM_CLS_OP",
              "--n_ctx", "2"]
    opts = FLAGSHIP_OPTS + ["INPUT.TRANSFORMS", repr(choices), "DATASET.NAME", "Synthetic",
                            "DATASET.NUM_SHOTS", str(TRAINER_SHOTS), "TRAIN.CHECKPOINT_FREQ", "1",
                            "TRAIN.PRINT_FREQ", "1"]
    parser = entry.build_parser()
    expected = train_step_launches(cfg)
    steps, resumed = [], {}
    rec = Recorder(torch)

    def after_step(trainer, batch, out):
        now = dict(cuda_lib.LAUNCHES)
        got = {k: now[k] - rec.before[k] for k in now}
        rec.before = now
        if got != expected:
            raise AssertionError(f"trainer step {len(steps)}: launches {got}, expected {expected}")
        if not math.isfinite(out["loss"]):
            raise AssertionError(f"trainer step {len(steps)}: loss {out['loss']}")
        steps.append(dict(epoch=trainer.epoch + 1, loss=out["loss"], lr=out["lr"],
                          wall=rec.times["forward_backward"][-1], data=trainer.data_time.val))

    def after_resume(trainer, directory, out):
        resumed["epoch"] = out
        resumed["state"] = ckpt.optimizer_state_arrays(trainer.optimizer, trainer.agg_params)

    def before_step(trainer, batch):
        rec.before = dict(cuda_lib.LAUNCHES)

    cls = trainer_mod.MM_CLS_OP
    rec.wrap(cls, "forward_backward", before=before_step, after=after_step)
    rec.wrap(cls, "resume_model_if_exist", after=after_resume)
    rec.wrap(cls, "build_data_manager")
    rec.wrap(trainer_mod.TrainerBase, "run_epoch")
    rec.wrap(cls, "test")
    rec.wrap(trainer_mod, "collect_exemplar_features")
    rec.wrap(trainer_mod, "mm_generate_classifiers")
    try:
        cuda_lib.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        run_entry(parser, entry, common + ["--output-dir", str(out)] + opts
                  + ["OPTIM.MAX_EPOCH", "2", "TEST.NO_TEST", "True"])
        run1_s = time.perf_counter() - t
        if resumed.get("epoch") != 0 or len(steps) != 2:
            raise AssertionError(f"first run: resumed at {resumed.get('epoch')}, {len(steps)} steps")
        pl = out / "prompt_learner"
        for name in ("model-1.npz", "model-2.npz", "model.pth.tar-1", "model.pth.tar-2",
                     "checkpoint"):
            if not (pl / name).is_file():
                raise AssertionError(f"first run wrote no {name}")
        if (pl / "checkpoint").read_text() != "model-2.npz":
            raise AssertionError("the checkpoint pointer does not name model-2.npz")

        os.environ["OVMR_PROFILE_DIR"] = str(work / "profile")
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        trainer = run_entry(parser, entry, common + ["--output-dir", str(out)] + opts
                            + ["OPTIM.MAX_EPOCH", "3", "TEST.NO_TEST", "True"])
        run2_s = time.perf_counter() - t
        os.environ.pop("OVMR_PROFILE_DIR")
        train_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if resumed["epoch"] != 2 or trainer.start_epoch != 2 or len(steps) != 3:
            raise AssertionError(f"second run: resumed at {resumed['epoch']}, {len(steps)} steps")
        # the learning rate is the schedule's, set before each epoch
        with np.load(pl / "model-2.npz") as saved:
            want = {k[len("opt//"):]: saved[k] for k in saved.files
                    if k.startswith("opt//") and k != "opt//.hyperparams//lr"}
        got = {k: v for k, v in resumed["state"].items() if k != ".hyperparams//lr"}
        differ = sorted(set(got) ^ set(want)) + [
            k for k in want if k in got and not np.array_equal(got[k], want[k])]
        if differ:
            raise AssertionError(f"the resumed adam state differs from the one saved at epoch 2 "
                                 f"in {differ[:4]}")
        if int(got[".inner_state//1//.count"]) != 2:
            raise AssertionError(f"resumed adam step count {got['.inner_state//1//.count']}, not 2")
        print(f"[trainer] resumed at epoch 2: adam step count 2 and all {len(want) - 2} moments "
              "equal to those saved", flush=True)
        prof, epoch_s = trainer.epoch_profile
        busy_ms = sum(
            (getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0))
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3

        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        evaluator = run_entry(parser, entry, common + [
            "--output-dir", str(eval_out), "--model-dir", str(out), "--load-epoch", "3",
            "--eval-only", "--eval_mode", "fusion", "--eval_tau", "10"] + opts
            + ["OPTIM.MAX_EPOCH", "3"])
        run3_s = time.perf_counter() - t
        eval_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        launches, shapes = dict(cuda_lib.LAUNCHES), dict(cuda_lib.LAUNCH_SHAPES)

        art = torch.load(eval_out / "mm_classifiers.pt", weights_only=False)
        vt = torch.load(eval_out / "visual_tokens.pt", weights_only=False)["visual_tokens"]
        outs = {k: v.numpy() for k, v in art.items()}
        outs["visual_tokens"] = vt.numpy()
        check_classifiers(np, outs, TRAINER_CLASSES, cfg.embed_dim, 2, unit_tol=1e-2)
        log = (eval_out / "log.txt").read_text()
        for name in ("acc_per_class.csv", "f1_per_class.csv"):
            if not (eval_out / name).is_file():
                raise AssertionError(f"the eval wrote no {name}")
    finally:
        rec.restore()
        os.environ.pop("OVMR_SYNTHETIC", None)
        shutil.rmtree(work, ignore_errors=True)
    if "=> result" not in log or "* accuracy:" not in log or "(epoch = 3)" not in log:
        raise AssertionError("the eval log lacks the => result block or the epoch-3 load")
    result = log[log.index("=> result"):].splitlines()[:6]
    n_test = TRAINER_CLASSES * 4
    if f"* total: {n_test:,}" not in result:
        raise AssertionError(f"the eval did not score {n_test} test images: {result}")
    if launches["fused_attention"] != 4:
        raise AssertionError(f"the eval launched K6 {launches['fused_attention']} times, not 4")
    for kernel in ("fused_attn_half", "fused_attn_half_masked", "fused_mlp_half",
                   "attn_half_bwd_dx_masked", "mlp_half_bwd_dx", "gemm_wgmma", "attn_core",
                   "attn_bwd_core_short", "fused_attention"):
        if launches[kernel] <= 0:
            raise AssertionError(f"kernel {kernel} was not launched on the trainer path")

    smi = nvidia_smi_line()
    print(f"[trainer] ({smi}) Synthetic dataset written and read in "
          f"{rec.times['build_data_manager'][0]:.1f} s; runs: train 2 epochs {run1_s:.1f} s, "
          f"resume to 3 {run2_s:.1f} s, eval {run3_s:.1f} s", flush=True)
    for s in steps:
        print(f"[trainer] ({smi}) epoch {s['epoch']} step: loss {s['loss']:.4f}, lr {s['lr']:.3g}, "
              f"step wall {s['wall'] * 1e3:.1f} ms (the trainer's meters: data "
              f"{s['data'] * 1e3:.1f} ms before it)", flush=True)
    print(f"[trainer] ({smi}) epoch walls: "
          f"{', '.join(f'{x:.2f} s' for x in rec.times['run_epoch'])}", flush=True)
    print(f"[trainer] ({smi}) device busy over the profiled epoch {busy_ms:.1f} ms of "
          f"{epoch_s * 1e3:.1f} ms ({100 * busy_ms / (epoch_s * 1e3):.1f}%)", flush=True)
    encode_s = rec.times["collect_exemplar_features"][0]
    gen_s = rec.times["mm_generate_classifiers"][0]
    test_s = rec.times["test"][0]
    print(f"[trainer] ({smi}) eval: exemplar encode {encode_s:.2f} s "
          f"({TRAINER_CLASSES * TRAINER_SHOTS} images), generation {gen_s:.2f} s, test pass "
          f"{test_s - encode_s - gen_s:.2f} s ({n_test} images); {' '.join(result[1:])}",
          flush=True)
    print(f"[trainer] ({smi}) peak device memory: training {train_peak:.2f} GiB, eval "
          f"{eval_peak:.2f} GiB", flush=True)
    print(f"[trainer] launches over the three runs: {launches}", flush=True)
    for key, count in sorted(shapes.items()):
        print(f"[trainer]   {key[0]} {list(key[1])} {key[2]}: {count}", flush=True)
    del trainer, evaluator
    return launches, shapes


def main() -> int:
    if not (ROOT / "ovmr_tpu_torch").is_dir():
        print("chip_smoke: the ovmr_tpu_torch package is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    # full fp32 products in the plain versions and the yardsticks
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from ovmr_tpu_torch.ops import cuda_lib

    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    print(f"[device] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    build_s = cuda_lib.build_all()
    print(f"[device] kernels built in {build_s:.1f} s into {cuda_lib.BUILD_DIR}", flush=True)

    from ovmr_tpu_torch.api import OVMRGenerator
    from ovmr_tpu_torch.models import clip as tclip
    from ovmr_tpu_torch.models.aggregator import init_aggregator

    kernels = kernel_checks(torch, F)
    checked = {entry["shape_key"] for entry in kernels}

    def all_checked(what, shapes):
        """Every launch of a path ran at a shape phase 2 held and timed."""
        unchecked = {key: n for key, n in shapes.items() if key not in checked}
        if unchecked:
            raise AssertionError(f"{what} launches at shapes phase 2 did not check: {unchecked}")

    paths = {}
    cfg = tclip.VIT_B16
    t0 = time.perf_counter()
    clip_params = tclip.init_params(cfg, seed=0)
    agg_params = init_aggregator(width=cfg.embed_dim, n_ctx=2, seed=0)
    gen = OVMRGenerator(clip_params, cfg, agg_params, dtype=torch.bfloat16, device="cuda")
    print(f"[slice] ViT-B/16 bf16 generator ready in {time.perf_counter() - t0:.1f} s",
          flush=True)
    paths["serving"] = serving_slice(torch, np, "slice", gen, n_requests=3)[:2]
    all_checked("serving", paths["serving"][1])
    del gen
    fp32_path(torch, np, "fp32", lambda device: OVMRGenerator(
        clip_params, cfg, agg_params, dtype=torch.float32, device=device),
        n_cls=4, shots=4, n_queries=8)
    paths["training"] = training_slice(torch, np, clip_params, agg_params)
    all_checked("training", paths["training"][1])
    fp32_train_step(torch, np, clip_params, agg_params)

    # ViT-L/14@336px serving, through the entry point a user calls; no local
    # checkpoint exists, so the towers are random from the seed (it warns)
    def vitl(device, dtype):
        t = time.perf_counter()
        gen = OVMRGenerator.from_checkpoints("ViT-L/14@336px", n_ctx=2, dtype=dtype,
                                             device=device, seed=0)
        print(f"[vitl336] generator on {device} ({str(dtype).removeprefix('torch.')}) ready "
              f"in {time.perf_counter() - t:.1f} s", flush=True)
        return gen

    gen_l = vitl("cuda", torch.bfloat16)
    launches, shapes, single_outs = serving_slice(torch, np, "vitl336", gen_l, n_requests=2,
                                                  warmups=1)
    paths["vitl336"] = (launches, shapes)
    all_checked("vitl336", paths["vitl336"][1])
    torch.cuda.empty_cache()
    cpu_out, cpu_probs = fp32_path(torch, np, "vitl336-fp32",
                                   lambda device: vitl(device, torch.float32),
                                   n_cls=2, shots=2, n_queries=4)

    # the same model on a model axis of 2, through the MM_CLS_OP serving
    # seams: bf16 requests against the single-card ones, fp32 against the CPU
    paths["vitl336_tp"] = tp_serving_slice(torch, np, gen_l, single_outs)
    all_checked("vitl336_tp", paths["vitl336_tp"][1])
    del gen_l
    torch.cuda.empty_cache()
    all_checked("vitl336-tp-fp32", tp_fp32_check(torch, np, vitl("cuda", torch.float32),
                                                 cpu_out, cpu_probs))
    torch.cuda.empty_cache()
    vision_backward(torch)
    torch.cuda.empty_cache()
    paths["trainer"] = trainer_phase(torch, np)
    all_checked("trainer", paths["trainer"][1])

    for entry in kernels:
        # launches: the wrapper's count over the three ViT-B/16 requests +
        # classify, the three timed training steps, the two ViT-L/14@336px
        # requests + classify, the two on a model axis of 2 + classify and
        # phase 12's three trainer runs (each read with the counts zeroed
        # just before); launches_at_shape:
        # those at this entry's shape and dtype
        key = entry.pop("shape_key")
        for path, (launches, shapes) in paths.items():
            entry[f"launches_{path}"] = launches[entry["kernel"]]
        entry["launches"] = sum(launches[entry["kernel"]] for launches, _ in paths.values())
        entry["launches_at_shape"] = sum(shapes.get(key, 0) for _, shapes in paths.values())

    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
