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
   12's eval heads (192 classes x (8 shots + 2 vokens), bf16). OVMR† stage
   2 (phases 14-15, bf16): K1 and K2 at the image tower's batch 1 and test
   batch 100, and K1-causal, K2, K3 and K4 at ImageNet's 1000 prompts x 77. Serving at
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
   with ``torch.autograd.grad`` through SDPA as its yardstick. The
   multi-resolution collate's extreme draws (phase 18): K1 and K2 at
   ViT-B/16's 50 and 3529 tokens (112 x 112 and 672 x 1344), 96 images in
   bf16 and 4 in fp32; the plain and library versions of 3529 tokens run 7
   images at a time. Beside every K1 and K7 case, the attention core those launch
   (``attn_core``) alone at the same B, L, width and heads, with SDPA on
   the same q/k/v as its library yardstick. Each case is checked as soon as it
   is built, and timed beside its plain version, one PyTorch library call
   chain computing the same function (a yardstick the port never calls; for K3 and K4
   ``torch.autograd.grad`` with respect to the input through the library
   forward) and its bound on the card; a kernel's or library call's time
   is the median of five means over back-to-back calls, with their spread,
   the plain version's one such mean.
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
13. The device-augmented trainer: ``ops/augment.augment_batch`` on the card
   against the CPU with the same draws at 8 x 256² -> 224 (fp32 within 1e-5
   of scale, bf16 within 2 ulp), its device time at the trainer's 1536 x
   256² -> 224 (bf16, NHWC) beside its bound, and the host-to-device copy
   of a uint8 batch beside phase 12's fp32 one; then phase 12's three runs
   with ``CUDA.DEVICE_AUGS True`` and ``CUDA.CACHE_SIDE 256`` over an
   ``ImageNet21kP`` tree (``imagenet_21k_P/split_fewshot/shot_8-seed_1.pkl``
   written with ``save_fewshot_pickle`` over phase 12's PNGs, 192 classes x
   8 shots; its eval scores the 1536 training images, ``test=train``). The
   trainer builds the decode-once cache under ``OVMR_CACHE_DIR`` in its
   first epoch; a second build in another directory must be bit-equal to
   that file. Every step's launches equal phase 5's exactly (the
   augmentation launches no counted kernel). Prints the cache build, the
   epochs, the data meter, the step, the augmentation, the copy, the busy
   share and peak memory.
14. OVMR† stage 2: the CoOp trainer (registered as ``MM_CLS``) through
   ``ovmr_tpu_torch.train.main`` with
   ``configs/trainers/MM_CLS/vit_b16_c16_ep10_batch1.yaml`` as it is
   (ViT-B/16, bf16, sgd lr 0.002, batch 1, n_ctx 16) over phase 12's 192
   classes at 1 shot, with the ``visual_tokens.pt`` phase 12's eval
   exported as its frozen vokens: train 1 epoch (192 steps), resume to 2
   (sgd's count and momentum as saved; its epoch profiled), then the
   fusion eval of epoch 2 (768 test images). Every step launches exactly
   K1 12, K1-causal 36, K2 48, K4 36 and K3-causal 36 (each with its
   short core; 372 wgmma GEMMs). Prints the epochs, the warm step, the
   data meter, the busy share and peak memory. Then CoOp's one-prompt step
   at ImageNet's 1000 classes timed directly (K1 12 + 12 causal, K2 24, K3
   12, K4 12 a step), and one fp32 CoOp step over 4 classes on the card
   against the CPU (loss within 1e-4, the ctx gradient within 1e-4 of its
   scale).
15. ``ZeroshotCLIP2`` through the entry point over the same 192 classes
   (7 SELECT templates plus the custom one; the test pass at batch 100,
   exact launches), ``clip_compat.load("ViT-B/16")`` in smoke mode (a bf16
   contrastive forward of 100 preprocessed PNGs x 192 prompts, read as a
   path of its own with exact launches; fp32 logits card vs CPU within
   1e-4), and ``python -m ovmr_tpu_torch.infer`` as
   three processes at once over 32 of phase 12's PNGs with phase 12's
   ``mm_classifiers.pt``: bf16 on the card, and fp32 on the card and on
   the CPU, whose top-5 labels must be equal (scores within 1e-4).
16. The ModifiedResNet towers at full width (seeded random, bf16):
   ``clip_compat.load("RN50")`` (a contrastive forward of 100 of phase 12's
   PNGs x 192 prompts: K1-causal 12 and K2 12 at 192 x 77 x 512, no vision
   K1; fp32 logits card vs CPU within 1e-4), ``ZeroshotCLIP2`` at RN50
   through the entry point (8 templates, exact launches), CoOp at RN50
   (``configs/trainers/CoOp/vit_b16_c16_ep10_batch1.yaml``, one epoch of
   192 steps at batch 1 on phase 12's vokens, every step's K1-K4 exact, the
   fusion eval), ``OVMRGenerator.from_checkpoints("RN101")`` (a warm-up and
   two requests of 32 x 16 at 224, ``classify()`` of 256 queries: K1-causal
   72, K2 72, K6 8, no vision K1; the image tower's device time on 512
   exemplars beside its bound), and an fp32 RN101 request at 2 x 2 card vs
   CPU (classifiers 1e-4, fusion weights 1e-3, scores 1e-4).
17. int8 serving: the MM_CLS_OP fusion eval with ``CUDA.INT8 True`` over
   phase 12's epoch 3 (192 classes) through the entry point, launching no
   K1/K2 and K6 four times; its classifiers against phase 12's bf16 ones
   (least row cosine, floor 0.99) and its walls beside phase 12's;
   ``dense_int8`` at ViT-B/16's four block shapes card vs CPU (int8
   activations and int32 products equal, output within 1e-6 of scale);
   an fp32-activation int8 request at 4 x 4: its 192 ``dense_int8`` calls
   replayed on the CPU from the card's inputs (within 1e-6 of scale), its
   48 blocks replayed on the CPU from the card's inputs with the products
   forced to the card's (outputs equal; every quantizer input within 1e-3
   of a step of the card's, so an activation that rounds otherwise lies on
   a .5 boundary; the count printed), and the classifiers card vs CPU
   within 0.9 of int8's own distance from the float towers (max abs and
   1 - least row cosine).
18. The multi-resolution collate: phase 12's recipe with
   ``DATALOADER.MULTI_RES_COLLATE True``, cut to 48 classes x 4 instances
   (192 images a step), four steps from the seed, each at its drawn shape
   with exact launches and a finite loss (the drawn (H, W), tokens, step
   wall, K1 launches at that length and peak memory printed); one drawn
   batch's fp32 image features (an image pass of 96) card vs CPU within
   1e-4; the largest draw (672 x 1344, 3529 tokens) at 8 and 24 classes x
   4, whose peak memory gives the largest batch that fits the card, and one
   step at nine tenths of that batch. Every step counts to the path. Then
   every block kernel is held and timed at each shape those steps and the
   fp32 pass launched that phase 2 did not check (the draws, and the
   prompt sets' batch of the step's classes, are known only now; at 3529
   tokens one round of one call each), and the path's launches must all
   be at checked shapes.
19. The data axis: (d) two ranks share the card over gloo (NCCL refuses
   two ranks on one card) and train MM_CLS_OP through
   ``ovmr_tpu_torch.train.main`` over phase 12's data for two steps, each
   rank decoding its 96 classes of every batch: losses, aggregator and
   adam state equal on both, the npz written by rank 0 alone; then (a)
   the flagship step (ViT-B/16 bf16, 192 x 8, the device augmentation with
   injected draws, dropout 0, sgd) on one program and on 4 local data
   shards: exactly 4x one program's launches, the loss and each leaf's
   update against one program's (and the same in fp32 on 48 classes, to
   fp32 rounding), walls and peak memory; (b) data 2 x model 2 (K7/K8 in
   every block, exact launches) against one program; (c) the process-group
   branch over NCCL at world size 1 against the local shard, bit for bit,
   with the NCCL kernels' share of a profiled step; (e) classifier
   generation and the fusion at 1000 classes x 16 shots on 4 local shards
   against one program (exact launches x4, classifiers within 2 bf16 ulp,
   the sharded fusion scan bit for bit). Every kernel is then held at each
   shape (a), (b) and (e) launched that no check held before.
20. The Dassl DG trainers, with torch's own TF32 flags: a PACS-layout tree
   (4 domains x 7 classes x 20 JPEGs at 227 px), then for Vanilla, DDAIG,
   DAELDG, CrossGrad and DomainMix two steps of the recipe at a tenth of
   its learning rate on the card and on the CPU from one seeded state and
   two batches (losses 1e-5, leaves 1e-4 of their scale; DDAIG and DAELDG
   at their JAX trajectory tests' tolerances), Vanilla's two local data
   shards against its one program, and the controls that must fail those
   gates (TF32 on, every gradient 20% off, per-shard BatchNorm); then the
   six runs through ``ovmr_tpu_torch.train.main`` at the published recipes
   (epochs cut), each with its warm step, epoch, data time, busy share,
   peak memory and no K1-K8 launch.
21. The Dassl DA trainers, with torch's own TF32 flags: an Office-31 tree
   (3 domains x 31 classes x 5 JPEGs at 256 px; amazon -> webcam) and a
   Digit-5 tree (5 domains x 10 classes x 20 + 4 PNGs at 32 x 32; the other
   four -> usps), then for each trainer two steps of
   its recipe at a cut of its learning rate (a tenth, or where the card
   drifts from itself or from the CPU at a tenth on some folder order, a
   hundredth or a thousandth; CDAC's own)
   on the card and on the CPU from one seeded state, two pairs of batches
   and the same dropout masks (the ResNet-50 recipes at a batch of 8, from
   a zero-residual start), held by phase 20's gates (M3SDA, DAEL and CDAC
   at their JAX trajectory tests' tolerances), DANN's two local data shards
   against its one program, and the controls that must fail those gates
   (TF32 on; every gradient 20% off, or for AdaBN, which takes no gradient,
   its statistics' reset skipped; per-shard BatchNorm); then the eleven runs
   through ``ovmr_tpu_torch.train.main``: SourceOnly, ADDA and AdaBN (from
   SourceOnly's checkpoint), DANN and DANN on 2 local data shards at
   Office-31's recipe, MCD, MME and SE on Digit-5's SourceOnly recipe, and
   M3SDA, DAEL and CDAC on their own (epochs cut; CDAC's to its 3
   unlabelled batches), each with its warm step, busy share, peak memory
   and no K1-K8 launch.
22. The Dassl SSL trainers, with torch's own TF32 flags: a CIFAR-10 tree
   (10 classes x 400 + 20 PNGs at 32 x 32), then for FixMatch, SupBaseline,
   EntMin, MeanTeacher and MixMatch two steps of CIFAR-10's FixMatch recipe
   (WRN-28-2; the others on the same yamls) at a hundredth of its learning
   rate (where the card's drift stays inside the gates) and a batch of
   16 + 64 on the card and on the CPU from one seeded state, two pairs of
   batches and the same draws, held by phase 20's gates (MeanTeacher's
   teacher too), FixMatch's two local data shards against its one
   program, and the controls that must fail those gates (TF32 on, every gradient 20% off,
   per-shard BatchNorm); then the six runs through
   ``ovmr_tpu_torch.train.main`` (FixMatch, FixMatch on 2 local data
   shards, SupBaseline, EntMin, MeanTeacher, MixMatch; 250 labels, one
   epoch of the labelled stream's 3 steps), each with its warm step, busy
   share, peak memory and no K1-K8 launch; then lpclip's extractor
   (``ovmr_tpu_torch.lpclip``) over the train and test splits of Synthetic
   100 x 12 at 224 px with a random ViT-B/16 in bf16: images a second, K1
   and K2 12 + 12 a batch of 100 and no other kernel, raw finite features,
   and the fp32 features card vs CPU within 1e-4 of their scale.
23. The whole-batch Dassl trainers under a process group, on phases
   20-22's trees: DAELDG (PACS), M3SDA, DAEL, CDAC (Digit-5), MixMatch
   (CIFAR-10, two views) and Vanilla (PACS) on the MixStyle and EFDMix
   ResNet-18s (``resnet18_{ms,efdmix}_l123``, their coin at 1, every
   mixing call checked to mix) take their gates' two steps in one process
   on the card, then on two gloo ranks sharing the card (NCCL refuses two
   ranks on one card; the ranks start while the one process steps), each
   rank holding its block of every batch, from the same state, batches and
   host draws: each rank against the one process at phases 20-22's gates,
   the two ranks bit for bit, and the rank-local control (its gathers,
   blocks, domain groups and feature mixing of the rank's own rows), which
   must read at least ten times some gate; then DAEL through
   ``ovmr_tpu_torch.train.main`` on the two ranks with the sliced loader
   for two steps (equal losses, the npz by rank 0 alone); the two-rank and
   one-process walls, peak memory, no K1-K8.

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

import contextlib
import json
import math
import random
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
    _, busy_ms, _ = device_times(torch, lambda: [fn() for _ in range(reps)])
    return busy_ms / reps


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


def slice_step(b: int, h: int, l: int) -> int:
    """Images a plain version takes at once so that its fp32 scores
    ``[step, h, l, l]`` stay within 4 GiB: all ``b`` where they fit, else 64,
    or fewer where 64 images' do not fit."""
    per_image = h * l * l * 4
    if b * per_image <= 2 ** 32:
        return b
    return max(1, min(64, 2 ** 32 // per_image))


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
        # no second fp32 copy at std 1 (phase 18's largest draws take GiBs)
        t = torch.randn(*shape, generator=gen, device="cuda")
        return t if std == 1.0 else t * std

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
        # the plain version, ~10x the kernel, is a yardstick: one round (its
        # five took most of phase 2's wall)
        plain_ms = cuda_ms(c["plain"], c["reps"], 1)[0]
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
        step = slice_step(b, h, l)
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
    block_cases = (
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
        # OVMR† stage 2 (phase 14): the image tower at batch 1 and at the
        # recipe's test batch of 100 (phase 15's zero-shot and clip_compat
        # too), and one prompt over ImageNet's 1000 classes, forward and
        # backward
        ("vision-stage2-1", 1, 197, 768, 12, False, both[:1], False),
        ("vision-test-100", 100, 197, 768, 12, False, both[:1], False),
        ("text-imagenet-1000", 1000, 77, 512, 8, True, both[:1], True),
        # ViT-L/14@336px serving: the exemplar encode, classify()'s
        # queries, the fp32 phase's 4 images, one 32-class prompt set
        ("vitl336-vision-encode", 512, 577, 1024, 16, False, bf16, False),
        ("vitl336-vision-classify", 256, 577, 1024, 16, False, bf16, False),
        ("vitl336-vision-fp32", 4, 577, 1024, 16, False, fp32, False),
        ("vitl336-text-prompts", 32, 77, 768, 12, True, both, False),
        # the multi-resolution collate's extreme draws at ViT-B/16: 112 x
        # 112 (7 x 7 patches + 1 = 50 tokens) and 672 x 1344 (42 x 84 + 1 =
        # 3529), at an image pass of 96 in bf16 and at 4 images in fp32
        # (the shapes phase 18 draws are held after its steps, by
        # ``block_case``)
        ("multires-50", 96, 50, 768, 12, False, bf16, False),
        ("multires-50-fp32", 4, 50, 768, 12, False, fp32, False),
        ("multires-3529", 96, 3529, 768, 12, False, bf16, False),
        ("multires-3529-fp32", 4, 3529, 768, 12, False, fp32, False),)

    def block_case(case, b, l, d, h, masked, dtypes, bwd, timed=None):
        """K1 (causal where ``masked``), its attention core and K2 (K5 where
        the tier says so) at ``[b, l, d]`` with ``h`` heads, each in
        ``dtypes``, and K3/K4 too where ``bwd``. ``timed`` overrides the
        reps and rounds that the size picks."""
        p32 = params.setdefault(d, layer(d))
        x32 = randn(b, l, d)
        chunks = mlp_tier_chunks(l, d, 4 * d)  # > 0: this tower's MLP half is K5
        # the plain and library versions run 64 images at a time where the
        # fp32 scores of the whole batch would take more than 4 GiB, fewer
        # where 64 images' would (7 at 3529 tokens)
        step = slice_step(b, h, l)
        g32 = randn(b, l, d) if bwd else None
        mask = causal_mask(l, device="cuda") if masked else None
        name_k1 = "fused_attn_half_masked" if masked else "fused_attn_half"
        for dtype in dtypes:
            p = {k: v.to(dtype) for k, v in p32.items()}
            x = x32.to(dtype)
            it = x.element_size()
            tok = b * l
            peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_FP32
            timing = timed or dict(reps=10 if dtype == torch.bfloat16 and step == b else 3,
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
    for args in block_cases:
        block_case(*args)
    # the aggregator at embed width 512 (8 heads) and ViT-L's 768 (12 heads);
    # on the fp32 TP check's 2 classes padded to 8, 2 shots + 2 vokens; at
    # phase 12's eval, 192 classes of 8 shots + 2 vokens
    def attention_case(case, n, h, l, dh, dtypes):
        """K6 at ``[n, h, l, dh]`` in each of ``dtypes``."""
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

    for args in (("aggregator", 32, 8, 18, 64, both),
                 ("trainer-aggregator", 192, 8, 10, 64, bf16),
                 ("vitl336-aggregator", 32, 12, 18, 64, both),
                 ("vitl336-tp-fp32-aggregator", 8, 12, 4, 64, fp32)):
        attention_case(*args)

    vision_bwd_cases(torch, F, randn, check, params, layer, library_attn_half, library_mlp_half,
                     library_dx)
    gemm_cases(torch, randn, check)
    bwd_gemm_cases(torch, randn, check)
    bwd_core_cases(torch, F, randn, check)
    tp_case = tp_cases(torch, F, randn, check, check_core, sliced, both)
    # the cases that later phases call for the shapes their steps draw
    return results, dict(block=block_case, attention=attention_case, tp=tp_case)


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

    def tp_case(case, b, l, d, dl, nh, hl, masked, dtypes):
        """K7 (causal where ``masked``), its core and K8 at one shard's
        shape in each of ``dtypes``."""
        s32 = shards.setdefault((d, dl, hl), shard(d, dl, hl))
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
    for args in (
            ("vitl336-tp2-vision-encode", 512, 577, 1024, 512, 8, 2048, False, bf16),
            ("vitl336-tp2-vision-classify", 256, 577, 1024, 512, 8, 2048, False, bf16),
            ("vitl336-tp2-text-prompts", 32, 77, 768, 384, 6, 1536, True, bf16),
            ("vitl336-tp2-vision-fp32", 4, 577, 1024, 512, 8, 2048, False, fp32),
            ("vitl336-tp2-text-fp32", 8, 77, 768, 384, 6, 1536, True, fp32)):
        tp_case(*args)
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
    return tp_case


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
    torch.profiler, the device's busy milliseconds (:func:`device_busy_ms`)
    and its (ms, kernel name, launches) by kernel, largest first, without
    the annotation spans."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or getattr(e, "is_user_annotation",
                                                                      False):
            continue  # host ops: their device time is their kernels' time
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us / 1e3, e.key, e.count))
    rows.sort(reverse=True)
    return wall_ms, device_busy_ms(torch, prof), rows


def device_busy_ms(torch, prof):
    """The device's busy milliseconds in a finished torch.profiler profile:
    the summed durations of its kernels, copies and sets, read from the raw
    events. Not ``key_averages``: it builds a Python object for each of an
    epoch's ~10^6 events first, which takes minutes, and it counts the
    spans that annotations such as ``Optimizer.step`` project onto the
    device as device time too."""
    cuda = torch.autograd.DeviceType.CUDA
    return sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == cuda and not e.is_user_annotation()) / 1e6


def warm_busy_share(torch, prof, label):
    """The device's busy share of a profiled loop's warm steps: its busy
    time (as :func:`device_busy_ms` reads it) from the start of the second
    ``label`` annotation to the end of the last, over that span's wall,
    the host's data waits between the steps included; None under three
    steps."""
    cuda = torch.autograd.DeviceType.CUDA
    events = list(prof.profiler.kineto_results.events())
    steps = sorted((e.start_ns(), e.end_ns()) for e in events
                   if e.device_type() != cuda and e.name() == label)
    if len(steps) < 3:
        return None
    lo, hi = steps[1][0], steps[-1][1]
    busy = sum(e.duration_ns() for e in events if e.device_type() == cuda
               and not e.is_user_annotation() and lo <= e.start_ns() < hi)
    return busy / (hi - lo)


def profile_call(torch, what, fn):
    """Device time by kernel over one call of ``fn`` (torch.profiler), and
    the device's busy share of the call's wall time."""
    wall_ms, busy_ms, rows = device_times(torch, fn)
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

    def wrap(self, owner, name, before=None, after=None, label=None):
        """``label``: each call also a ``torch.profiler`` annotation of
        that name, ending after the device synchronise."""
        orig = getattr(owner, name)
        torch = self.torch

        def wrapper(*args, **kwargs):
            if before is not None:
                before(*args)
            t = time.perf_counter()
            with (torch.profiler.record_function(label) if label else contextlib.nullcontext()):
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


def trainer_runs(torch, np, work, tag, data_opts, n_test, wraps=()):
    """MM_CLS_OP through ``ovmr_tpu_torch.train.main`` on the card at
    ViT-B/16, bf16, the flagship recipe plus ``data_opts``, with the data
    under ``work/data`` and the outputs under ``work/tag``: train 2 epochs,
    resume to 3 (its epoch profiled), then the fusion eval, which must score
    ``n_test`` images. Every step's launches are exact. ``wraps`` are more
    (owner, method) pairs the Recorder times. Prints the runs' numbers and
    returns the launches and launches by shape over the three runs, and the
    Recorder, the steps and the summary numbers."""
    import os

    from ovmr_tpu_torch import train as entry
    from ovmr_tpu_torch.engine import checkpoint as ckpt
    from ovmr_tpu_torch.engine import trainer as trainer_mod
    from ovmr_tpu_torch.models import clip as tclip
    from ovmr_tpu_torch.ops import cuda_lib

    cfg = tclip.VIT_B16
    out, eval_out = work / tag / "train_out", work / tag / "eval_out"
    common = ["--root", str(work / "data"), "--seed", "1", "--trainer", "MM_CLS_OP",
              "--n_ctx", "2"]
    opts = FLAGSHIP_OPTS + data_opts + ["TRAIN.CHECKPOINT_FREQ", "1", "TRAIN.PRINT_FREQ", "1"]
    parser = entry.build_parser()
    expected = train_step_launches(cfg)
    steps, resumed = [], {}
    rec = Recorder(torch)

    def after_step(trainer, batch, out):
        now = dict(cuda_lib.LAUNCHES)
        got = {k: now[k] - rec.before[k] for k in now}
        rec.before = now
        if got != expected:
            raise AssertionError(f"{tag} step {len(steps)}: launches {got}, expected {expected}")
        if not math.isfinite(out["loss"]):
            raise AssertionError(f"{tag} step {len(steps)}: loss {out['loss']}")
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
    for owner, name in wraps:
        rec.wrap(owner, name)
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

        os.environ["OVMR_PROFILE_DIR"] = str(work / tag / "profile")
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
        print(f"[{tag}] resumed at epoch 2: adam step count 2 and all {len(want) - 2} moments "
              "equal to those saved", flush=True)
        prof, epoch_s = trainer.epoch_profile
        busy_ms = device_busy_ms(torch, prof)

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
    if "=> result" not in log or "* accuracy:" not in log or "(epoch = 3)" not in log:
        raise AssertionError("the eval log lacks the => result block or the epoch-3 load")
    result = log[log.index("=> result"):].splitlines()[:6]
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
    print(f"[{tag}] ({smi}) data manager built in "
          f"{rec.times['build_data_manager'][0]:.1f} s; runs: train 2 epochs {run1_s:.1f} s, "
          f"resume to 3 {run2_s:.1f} s, eval {run3_s:.1f} s", flush=True)
    for s in steps:
        print(f"[{tag}] ({smi}) epoch {s['epoch']} step: loss {s['loss']:.4f}, lr {s['lr']:.3g}, "
              f"step wall {s['wall'] * 1e3:.1f} ms (the trainer's meters: data "
              f"{s['data'] * 1e3:.1f} ms before it)", flush=True)
    print(f"[{tag}] ({smi}) epoch walls: "
          f"{', '.join(f'{x:.2f} s' for x in rec.times['run_epoch'])}", flush=True)
    print(f"[{tag}] ({smi}) device busy over the profiled epoch {busy_ms:.1f} ms of "
          f"{epoch_s * 1e3:.1f} ms ({100 * busy_ms / (epoch_s * 1e3):.1f}%)", flush=True)
    encode_s = rec.times["collect_exemplar_features"][0]
    gen_s = rec.times["mm_generate_classifiers"][0]
    test_s = rec.times["test"][0]
    print(f"[{tag}] ({smi}) eval: exemplar encode {encode_s:.2f} s "
          f"({TRAINER_CLASSES * TRAINER_SHOTS} images), generation {gen_s:.2f} s, test pass "
          f"{test_s - encode_s - gen_s:.2f} s ({n_test} images); {' '.join(result[1:])}",
          flush=True)
    print(f"[{tag}] ({smi}) peak device memory: training {train_peak:.2f} GiB, eval "
          f"{eval_peak:.2f} GiB", flush=True)
    print(f"[{tag}] launches over the three runs: {launches}", flush=True)
    for key, count in sorted(shapes.items()):
        print(f"[{tag}]   {key[0]} {list(key[1])} {key[2]}: {count}", flush=True)
    del trainer, evaluator
    summary = dict(busy_ms=busy_ms, epoch_s=epoch_s, train_peak=train_peak,
                   eval_peak=eval_peak, runs_s=(run1_s, run2_s, run3_s))
    return launches, shapes, rec, steps, summary


def trainer_phase(torch, np, work):
    """Phase 12: :func:`trainer_runs` over Synthetic (192 classes x 16
    images at 224 px, 8 shots, written under ``work/data``, which phases
    13-18 read again). Returns the launches and launches by shape, and the
    eval's exemplar-encode and generation walls (s)."""
    import importlib.util
    import os

    have_pil = importlib.util.find_spec("PIL") is not None
    choices = FLAGSHIP_TRANSFORMS if have_pil else ["random_flip", "normalize"]
    print(f"[trainer] PIL {'is' if have_pil else 'is not'} installed: train transforms "
          f"{choices}", flush=True)
    os.environ["OVMR_SYNTHETIC"] = f"{TRAINER_CLASSES},16,224"
    try:
        launches, shapes, rec, *_ = trainer_runs(
            torch, np, work, "trainer",
            ["INPUT.TRANSFORMS", repr(choices), "DATASET.NAME", "Synthetic",
             "DATASET.NUM_SHOTS", str(TRAINER_SHOTS)], n_test=TRAINER_CLASSES * 4)
    finally:
        os.environ.pop("OVMR_SYNTHETIC", None)
    return launches, shapes, (rec.times["collect_exemplar_features"][0],
                              rec.times["mm_generate_classifiers"][0])


# ---------------------------------------------------------------------------
# phase 13: the device-augmented trainer over an ImageNet21kP tree
# ---------------------------------------------------------------------------

CACHE_SIDE = 256


def augment_check(torch, np):
    """``augment_batch`` on the card against the CPU with the same draws, at
    one batch of 8 x 256² -> 224 (NHWC): fp32 within 1e-5 of scale, bf16
    within 2 ulp at the output's largest magnitude. Returns the errors."""
    from ovmr_tpu_torch.ops.augment import augment_batch, sample_augment_draws

    draws = sample_augment_draws(torch.Generator().manual_seed(0), 8, CACHE_SIDE, out_size=224)
    card_draws = {k: None if v is None else v.cuda() for k, v in draws.items()}
    imgs = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (8, CACHE_SIDE, CACHE_SIDE, 3), dtype=np.uint8))
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        ref = augment_batch(imgs, draws, out_size=224, out_dtype=dtype, out_layout="NHWC")
        got = augment_batch(imgs.cuda(), card_draws, out_size=224, out_dtype=dtype,
                            out_layout="NHWC")
        torch.cuda.synchronize()
        name = str(dtype).removeprefix("torch.")
        if got.dtype != dtype or got.shape != ref.shape or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"augment_batch {name} on the card: {got.dtype} {got.shape}")
        err, tol = float((got.cpu().float() - ref.float()).abs().max()), tolerance(dtype, ref)
        if err > tol:
            raise AssertionError(f"augment_batch {name} card vs CPU: {err:.3g} > {tol:.3g}")
        errs[name] = (err, tol)
        print(f"[augs] augment_batch 8 x {CACHE_SIDE}^2 -> 224 {name} card vs CPU: max_abs_err "
              f"{err:.3g} (tol {tol:.3g})", flush=True)
    return errs


def augment_times(torch, np, n=TRAINER_CLASSES * TRAINER_SHOTS):
    """Device ms of the step's augmentation at the trainer's batch (draws and
    ``augment_batch``, bf16 NHWC), its bound, and the host-to-device copy of
    the uint8 batch beside phase 12's fp32 one, as the trainer sends them."""
    from ovmr_tpu_torch.ops.augment import augment_batch, sample_augment_draws

    smi = nvidia_smi_line()
    gen = torch.Generator(device="cuda").manual_seed(1)
    imgs = torch.randint(0, 256, (n, CACHE_SIDE, CACHE_SIDE, 3), dtype=torch.uint8,
                         device="cuda", generator=gen)
    draws = sample_augment_draws(gen, n, CACHE_SIDE, out_size=224)
    aug = cuda_ms(lambda: augment_batch(imgs, draws, out_size=224, out_dtype=torch.bfloat16,
                                        out_layout="NHWC"), reps=3, rounds=3)
    draw = cuda_ms(lambda: sample_augment_draws(gen, n, CACHE_SIDE, out_size=224),
                   reps=3, rounds=3)
    # the crop's two products in fp32, and each input read once and the
    # bf16 output written once (the noise is an input)
    flops = 2.0 * n * 224 * CACHE_SIDE * CACHE_SIDE * 3 + 2.0 * n * 224 * 224 * CACHE_SIDE * 3
    moved = n * (CACHE_SIDE ** 2 * 3 + 224 * 224 * 3 * (4 + 2))
    bound, by = bound_ms(moved, flops, PEAK_FP32)
    print(f"[augs] ({smi}) augment_batch {n} x {CACHE_SIDE}^2 -> 224 bf16 NHWC: {aug[0]:.2f} ms "
          f"({aug[1]:.2f}-{aug[2]:.2f}); its draws {draw[0]:.2f} ms; bound {bound:.2f} ms "
          f"({by}: {flops / 1e9:.0f} GFLOP fp32, {moved / 1e6:.0f} MB)", flush=True)
    profile_call(torch, f"augment_batch {n} x {CACHE_SIDE}^2 -> 224", lambda: augment_batch(
        imgs, draws, out_size=224, out_dtype=torch.bfloat16, out_layout="NHWC"))
    del imgs, draws
    torch.cuda.empty_cache()

    def copy_ms(arr):
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            torch.as_tensor(arr).to("cuda")
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return sorted(times)[1]

    u8 = np.random.default_rng(0).integers(0, 256, (TRAINER_CLASSES, TRAINER_SHOTS, CACHE_SIDE,
                                                    CACHE_SIDE, 3), dtype=np.uint8)
    f32 = np.full((TRAINER_CLASSES, TRAINER_SHOTS, 3, 224, 224), 0.5, np.float32)
    u8_ms, f32_ms = copy_ms(u8), copy_ms(f32)
    print(f"[augs] ({smi}) host-to-device copy from pageable memory: uint8 batch "
          f"{u8.nbytes / 1e6:.0f} MB {u8_ms:.1f} ms; phase 12's fp32 batch {f32.nbytes / 1e6:.0f} "
          f"MB {f32_ms:.1f} ms", flush=True)
    torch.cuda.empty_cache()
    return aug[0], u8_ms


def augs_trainer_phase(torch, np, work):
    """Phase 13: :func:`trainer_runs` with ``CUDA.DEVICE_AUGS True`` over an
    ``ImageNet21kP`` tree: the prebuilt split pickle this phase writes over
    phase 12's Synthetic PNGs (192 classes x 8 shots). The trainer builds the
    decode-once cache at ``CUDA.CACHE_SIDE`` 256 under ``OVMR_CACHE_DIR``
    (a directory of ``work``) in its first epoch; a second build in another
    directory must be bit-equal to the file it wrote. Returns the launches
    and launches by shape."""
    import importlib.util
    import os

    from ovmr_tpu_torch.data import cache as cache_mod
    from ovmr_tpu_torch.data.datasets.synthetic import Synthetic
    from ovmr_tpu_torch.data.datum import load_fewshot_pickle, save_fewshot_pickle
    from ovmr_tpu_torch.utils import get_cfg_default

    if importlib.util.find_spec("PIL") is None:
        raise AssertionError("phase 13 decodes the cache with PIL, which is not installed")
    errs = augment_check(torch, np)
    aug_ms, u8_ms = augment_times(torch, np)

    cfg = get_cfg_default()
    cfg.DATASET.ROOT, cfg.DATASET.NUM_SHOTS, cfg.SEED = str(work / "data"), TRAINER_SHOTS, 1
    os.environ["OVMR_SYNTHETIC"] = f"{TRAINER_CLASSES},16,224"
    try:
        train = Synthetic(cfg).train_x  # phase 12's PNGs, read again
    finally:
        os.environ.pop("OVMR_SYNTHETIC")
    split = work / "data" / "imagenet_21k_P" / "split_fewshot" / f"shot_{TRAINER_SHOTS}-seed_1.pkl"
    save_fewshot_pickle(str(split), {"train": train})
    print(f"[augs] wrote {split.relative_to(work)}: {len(train)} Datums over "
          f"{len({d.label for d in train})} classes", flush=True)

    os.environ["OVMR_CACHE_DIR"] = str(work / "cache")
    try:
        launches, shapes, rec, steps, summary = trainer_runs(
            torch, np, work, "augs",
            ["INPUT.TRANSFORMS", repr(FLAGSHIP_TRANSFORMS), "DATASET.NAME", "ImageNet21kP",
             "DATASET.NUM_SHOTS", str(TRAINER_SHOTS), "CUDA.DEVICE_AUGS", "True",
             "CUDA.CACHE_SIDE", str(CACHE_SIDE)],
            n_test=TRAINER_CLASSES * TRAINER_SHOTS,
            wraps=[(cache_mod.ImageArrayCache, "_build")])
    finally:
        os.environ.pop("OVMR_CACHE_DIR")
    builds = rec.times.get("_build", [])
    files = sorted((work / "cache").glob("imgs_*.npy"))
    if len(builds) != 1 or len(files) != 1:
        raise AssertionError(f"the trainer built the cache {len(builds)} times into {files}")
    items = load_fewshot_pickle(str(split))["train"]
    t = time.perf_counter()
    again = cache_mod.ImageArrayCache(items, side=CACHE_SIDE, cache_dir=str(work / "cache2"))
    rebuild_s = time.perf_counter() - t
    written = np.load(files[0])
    if written.shape != (len(items), CACHE_SIDE, CACHE_SIDE, 3) or written.dtype != np.uint8:
        raise AssertionError(f"cache file {written.shape} {written.dtype}")
    if Path(again.path).name != files[0].name or not np.array_equal(written, again.images):
        raise AssertionError("a second build of the cache differs from the trainer's file")
    smi = nvidia_smi_line()
    print(f"[augs] ({smi}) cache {files[0].name}: {written.nbytes / 1e6:.0f} MB, built by the "
          f"trainer in {builds[0]:.2f} s; a second build in {rebuild_s:.2f} s is bit-equal",
          flush=True)
    walls = rec.times["run_epoch"]
    print(f"[augs] ({smi}) summary beside phase 12: epoch walls "
          f"{', '.join(f'{x:.2f} s' for x in walls)} (the first holds the cache build); data "
          f"meter a step {', '.join(f'{s['data'] * 1e3:.1f}' for s in steps)} ms; step walls "
          f"{', '.join(f'{s['wall'] * 1e3:.1f}' for s in steps)} ms; augment {aug_ms:.2f} ms; "
          f"uint8 copy {u8_ms:.1f} ms; busy {100 * summary['busy_ms'] / (summary['epoch_s'] * 1e3):.1f}% "
          f"of the profiled epoch; peak {summary['train_peak']:.2f} GiB training, "
          f"{summary['eval_peak']:.2f} GiB eval; augment card vs CPU "
          f"{', '.join(f'{k} {v[0]:.3g} (tol {v[1]:.3g})' for k, v in errs.items())}", flush=True)
    return launches, shapes



# ---------------------------------------------------------------------------
# phase 14: OVMR† stage 2 (CoOp on frozen vokens) through its entry point
# ---------------------------------------------------------------------------

# OVMR†'s recipe: ViT-B/16, sgd at lr 0.002, batch 1, n_ctx 16, bf16
STAGE2_YAML = "configs/trainers/MM_CLS/vit_b16_c16_ep10_batch1.yaml"
STAGE2_SHOTS = 1
COOP_YAML = "configs/trainers/CoOp/vit_b16_c16_ep10_batch1.yaml"
IMAGENET_CLASSES = 1000


def coop_step_launches(cfg, prompts):
    """Exact launches of one bf16 CoOp step at batch 1: the image tower once
    (no gradient), and ``prompts`` text-tower passes forward (K1-causal, K2)
    and backward (K4, K3-causal, each K3 with its one-launch short core). A
    ModifiedResNet image tower is convolutions: it launches none."""
    v = 0 if cfg.is_resnet else cfg.vision_layers
    t = cfg.transformer_layers * prompts
    return {
        "fused_attn_half": v, "fused_attn_half_masked": t, "attn_core": v + t,
        "fused_mlp_half": v + t, "fused_mlp_half_chunked": 0,
        "attn_half_bwd_dx_masked": t, "mlp_half_bwd_dx": t, "attn_half_bwd_dx": 0,
        "fused_attention": 0, "tp_attn_half_partial": 0, "tp_attn_half_partial_masked": 0,
        "tp_mlp_half_partial": 0,
        # two inside each K1, K2 and K4, three inside each K3
        "gemm_wgmma": 4 * (v + t) + 5 * t,
        "attn_bwd_core_short": t, "attn_bwd_core_tiled": 0,
    }


def stage2_runs(torch, np, work):
    """CoOp (registered as MM_CLS) through ``ovmr_tpu_torch.train.main`` with
    OVMR†'s yaml over phase 12's Synthetic PNGs (192 classes, 1 shot, so an
    epoch is 192 steps of batch 1) and the ``visual_tokens.pt`` phase 12's
    fusion eval exported: train 1 epoch, resume to 2 (its epoch profiled;
    sgd's count and momentum as saved), then the fusion eval of epoch 2.
    Every step's launches are exact. Returns the launches and launches by
    shape over the three runs."""
    import os

    from ovmr_tpu_torch import train as entry
    from ovmr_tpu_torch.engine import checkpoint as ckpt
    from ovmr_tpu_torch.engine import coop as coop_mod
    from ovmr_tpu_torch.engine import trainer as trainer_mod
    from ovmr_tpu_torch.models import clip as tclip
    from ovmr_tpu_torch.ops import cuda_lib

    cfg = tclip.VIT_B16
    vt_path = work / "trainer" / "eval_out" / "visual_tokens.pt"
    vt = torch.load(vt_path, weights_only=False)["visual_tokens"]
    if tuple(vt.shape) != (TRAINER_CLASSES, 2, cfg.embed_dim):
        raise AssertionError(f"phase 12 exported vokens of shape {tuple(vt.shape)}")
    out, eval_out = work / "stage2" / "train_out", work / "stage2" / "eval_out"
    common = ["--root", str(work / "data"), "--seed", "1", "--trainer", "MM_CLS",
              "--config-file", str(ROOT / STAGE2_YAML), "--visual_token_path", str(vt_path)]
    opts = ["DATASET.NAME", "Synthetic", "DATASET.NUM_SHOTS", str(STAGE2_SHOTS),
            "CUDA.DEVICE", "cuda", "TRAIN.CHECKPOINT_FREQ", "1"]
    n_steps = TRAINER_CLASSES * STAGE2_SHOTS
    n_test = TRAINER_CLASSES * 4
    parser = entry.build_parser()
    expected = coop_step_launches(cfg, 3)
    steps, resumed = [], {}
    rec = Recorder(torch)

    def before_step(trainer, batch):
        rec.before = dict(cuda_lib.LAUNCHES)

    def after_step(trainer, batch, out):
        now = dict(cuda_lib.LAUNCHES)
        got = {k: now[k] - rec.before[k] for k in now}
        if got != expected:
            raise AssertionError(f"stage 2 step {len(steps)}: launches {got}, expected {expected}")
        if not math.isfinite(out["loss"]):
            raise AssertionError(f"stage 2 step {len(steps)}: loss {out['loss']}")
        steps.append(dict(epoch=trainer.epoch + 1, loss=out["loss"], acc=out["acc"],
                          wall=rec.times["forward_backward"][-1], data=trainer.data_time.val))

    def after_resume(trainer, directory, out):
        resumed["epoch"] = out
        resumed["state"] = ckpt.optimizer_state_arrays(trainer.optimizer, trainer.params)

    cls = coop_mod.CoOp
    rec.wrap(cls, "forward_backward", before=before_step, after=after_step)
    rec.wrap(cls, "resume_model_if_exist", after=after_resume)
    rec.wrap(trainer_mod.TrainerBase, "run_epoch")
    rec.wrap(cls, "test")
    rec.wrap(cls, "get_fusion_weight")
    os.environ["OVMR_SYNTHETIC"] = f"{TRAINER_CLASSES},16,224"
    try:
        cuda_lib.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        first = run_entry(parser, entry, common + ["--output-dir", str(out)] + opts
                          + ["OPTIM.MAX_EPOCH", "1", "TEST.NO_TEST", "True"])
        run1_s = time.perf_counter() - t
        if (resumed.get("epoch") != 0 or len(steps) != n_steps or first.n_cls != TRAINER_CLASSES
                or first.cfg.OPTIM.NAME != "sgd" or first.n_ctx != 16):
            raise AssertionError(f"first run: resumed at {resumed.get('epoch')}, {len(steps)} "
                                 f"steps, {first.n_cls} classes, {first.cfg.OPTIM.NAME}")
        if not torch.equal(first.visual_tokens.cpu(), vt.float()):
            raise AssertionError("stage 2 did not load phase 12's vokens")
        pl = out / "prompt_learner"
        if (pl / "checkpoint").read_text() != "model-1.npz":
            raise AssertionError("the checkpoint pointer does not name model-1.npz")
        del first

        os.environ["OVMR_PROFILE_DIR"] = str(work / "stage2" / "profile")
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        trainer = run_entry(parser, entry, common + ["--output-dir", str(out)] + opts
                            + ["OPTIM.MAX_EPOCH", "2", "TEST.NO_TEST", "True"])
        run2_s = time.perf_counter() - t
        os.environ.pop("OVMR_PROFILE_DIR")
        train_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if resumed["epoch"] != 1 or trainer.start_epoch != 1 or len(steps) != 2 * n_steps:
            raise AssertionError(f"second run: resumed at {resumed['epoch']}, {len(steps)} steps")
        # sgd's state in optax's layout: the count and the momentum as saved
        with np.load(pl / "model-1.npz") as saved:
            want = {k[len("opt//"):]: saved[k] for k in saved.files
                    if k.startswith("opt//") and k != "opt//.hyperparams//lr"}
        got = {k: v for k, v in resumed["state"].items() if k != ".hyperparams//lr"}
        differ = sorted(set(got) ^ set(want)) + [
            k for k in want if k in got and not np.array_equal(got[k], want[k])]
        if differ or int(got[".count"]) != n_steps:
            raise AssertionError(f"the resumed sgd state differs from the one saved at epoch 1 "
                                 f"in {differ[:4]} (count {got.get('.count')})")
        print(f"[stage2] resumed at epoch 1: sgd count {n_steps} and the momentum "
              f"({', '.join(sorted(want))}) equal to those saved", flush=True)
        prof, epoch_s = trainer.epoch_profile
        busy_ms = device_busy_ms(torch, prof)
        del trainer, prof

        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        evaluator = run_entry(parser, entry, common + [
            "--output-dir", str(eval_out), "--model-dir", str(out), "--load-epoch", "2",
            "--eval-only"] + opts + ["OPTIM.MAX_EPOCH", "2"])
        run3_s = time.perf_counter() - t
        eval_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        launches, shapes = dict(cuda_lib.LAUNCHES), dict(cuda_lib.LAUNCH_SHAPES)
        fw = evaluator.classifiers["fusion_weight"]
        for key in ("mm_classifier", "vision_classifier", "text_classifier"):
            v = evaluator.classifiers[key]
            if v.shape != (TRAINER_CLASSES, cfg.embed_dim) or not np.isfinite(v).all():
                raise AssertionError(f"stage 2 {key}: {v.shape}")
        if fw.shape != (TRAINER_CLASSES, 3) or np.abs(fw.sum(-1) - 1).max() > 1e-5:
            raise AssertionError(f"stage 2 fusion weight {fw.shape}")
        log = (eval_out / "log.txt").read_text()
        del evaluator
    finally:
        rec.restore()
        os.environ.pop("OVMR_SYNTHETIC", None)
    if ("=> result" not in log or "(eval mode: CoOp fusion)" not in log
            or "(epoch = 2)" not in log):
        raise AssertionError("the stage-2 eval log lacks the => result block or the epoch-2 load")
    result = log[log.index("=> result"):].splitlines()[:6]
    if f"* total: {n_test:,}" not in result:
        raise AssertionError(f"the stage-2 eval did not score {n_test} test images: {result}")
    for kernel in ("fused_attn_half", "fused_attn_half_masked", "fused_mlp_half",
                   "attn_half_bwd_dx_masked", "mlp_half_bwd_dx", "gemm_wgmma", "attn_core",
                   "attn_bwd_core_short"):
        if launches[kernel] <= 0:
            raise AssertionError(f"kernel {kernel} was not launched on the stage-2 path")

    smi = nvidia_smi_line()
    walls = [s["wall"] * 1e3 for s in steps]
    for epoch in (1, 2):
        ep = [s for s in steps if s["epoch"] == epoch]
        w = sorted(s["wall"] * 1e3 for s in ep[3:])  # warm: after the first three
        d = sorted(s["data"] * 1e3 for s in ep[3:])
        print(f"[stage2] ({smi}) epoch {epoch}: {len(ep)} steps, loss {ep[0]['loss']:.4f} -> "
              f"{ep[-1]['loss']:.4f} (mean {sum(s['loss'] for s in ep) / len(ep):.4f}), step "
              f"wall warm median {w[len(w) // 2]:.1f} ms ({w[0]:.1f}-{w[-1]:.1f}), first "
              f"{walls[(epoch - 1) * n_steps]:.1f} ms; data meter median {d[len(d) // 2]:.2f} ms",
              flush=True)
    print(f"[stage2] ({smi}) epoch walls: "
          f"{', '.join(f'{x:.2f} s' for x in rec.times['run_epoch'])} (the second profiled); "
          f"runs: train {run1_s:.1f} s, resume {run2_s:.1f} s, eval {run3_s:.1f} s", flush=True)
    print(f"[stage2] ({smi}) device busy over the profiled epoch {busy_ms:.1f} ms of "
          f"{epoch_s * 1e3:.1f} ms ({100 * busy_ms / (epoch_s * 1e3):.1f}%)", flush=True)
    fuse_s = rec.times["get_fusion_weight"][0]
    print(f"[stage2] ({smi}) eval: fusion weight (exemplar encode + F1) {fuse_s:.2f} s, test "
          f"{rec.times['test'][0]:.2f} s in all ({n_test} images); {' '.join(result[1:])}",
          flush=True)
    print(f"[stage2] ({smi}) peak device memory: training {train_peak:.2f} GiB, eval "
          f"{eval_peak:.2f} GiB; launches a step {expected}", flush=True)
    for key, count in sorted(shapes.items()):
        print(f"[stage2]   {key[0]} {list(key[1])} {key[2]}: {count}", flush=True)
    return launches, shapes


def coop_trainer(torch, n_cls, device, dtype):
    """CoOp at ViT-B/16 full width with OVMR†'s yaml (seeded random towers,
    n_ctx 16, sgd) over ``n_cls`` class names, built as ``build_trainer``
    builds it but with no data manager, with random ctx and vokens."""
    from types import SimpleNamespace

    from ovmr_tpu_torch.engine.coop import CoOp
    from ovmr_tpu_torch.utils import get_cfg_default

    cfg = get_cfg_default()
    cfg.merge_from_file(str(ROOT / STAGE2_YAML))
    cfg.merge_from_list(["CUDA.DEVICE", device, "CUDA.DTYPE", dtype, "SEED", "1"])
    trainer = CoOp.__new__(CoOp)
    trainer.cfg = cfg
    names = [f"{VOCAB[i % len(VOCAB)]} {i}" for i in range(n_cls)]
    trainer.dm = SimpleNamespace(dataset=SimpleNamespace(classnames=names))
    trainer.build_model()
    gen = torch.Generator().manual_seed(11)
    width = trainer.clip_cfg.transformer_width
    trainer.visual_tokens = (0.02 * torch.randn(n_cls, 2, width, generator=gen)).to(trainer.device)
    with torch.no_grad():
        trainer.params["ctx"].copy_(0.02 * torch.randn(trainer.params["ctx"].shape, generator=gen))
    return trainer


def imagenet_stage2_steps(torch):
    """CoOp's step at ImageNet's 1000 classes, where it trains one prompt a
    step, timed directly: a warm-up of each prompt, then three timed steps of
    each (batch 1, bf16), each with exact launches. Returns the launches and
    launches by shape over the timed steps."""
    from ovmr_tpu_torch.models import clip as tclip
    from ovmr_tpu_torch.ops import cuda_lib

    t = time.perf_counter()
    trainer = coop_trainer(torch, IMAGENET_CLASSES, "cuda", "bfloat16")
    print(f"[stage2-1000] CoOp over {IMAGENET_CLASSES} classes ready in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(12)
    images = torch.randn(1, 3, 224, 224, generator=gen, device="cuda").to(torch.bfloat16)
    labels = torch.tensor([417], device="cuda")
    expected = coop_step_launches(tclip.VIT_B16, 1)
    for ind in range(3):
        trainer.train_step(images, labels, ind)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches, shapes, walls = {k: 0 for k in cuda_lib.LAUNCHES}, {}, {0: [], 1: [], 2: []}
    for i in range(9):
        ind = i % 3
        cuda_lib.reset_launches()
        t = time.perf_counter()
        loss, _ = trainer.train_step(images, labels, ind)
        torch.cuda.synchronize()
        walls[ind].append((time.perf_counter() - t) * 1e3)
        got = dict(cuda_lib.LAUNCHES)
        if got != expected or not math.isfinite(float(loss)):
            raise AssertionError(f"1000-class step {i}: launches {got}, loss {float(loss)}")
        for key, n in got.items():
            launches[key] += n
        for key, n in cuda_lib.LAUNCH_SHAPES.items():
            shapes[key] = shapes.get(key, 0) + n
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    smi = nvidia_smi_line()
    print(f"[stage2-1000] ({smi}) one-prompt step at {IMAGENET_CLASSES} classes, batch 1: "
          + "; ".join(f"{('mm', 'v', 't')[k]} {', '.join(f'{w:.1f}' for w in v)} ms"
                      for k, v in walls.items())
          + f"; peak {peak:.2f} GiB; launches a step {expected}", flush=True)
    profile_call(torch, f"one CoOp step at {IMAGENET_CLASSES} classes",
                 lambda: trainer.train_step(images, labels, 0))
    del trainer
    torch.cuda.empty_cache()
    return launches, shapes


def fp32_coop_step(torch):
    """One fp32 CoOp step at ViT-B/16 over 4 classes (three prompts, batch
    1) on the card and on the CPU from the same ctx, vokens and image: the
    loss within 1e-4 and the ctx gradient within 1e-4 of its scale."""
    from ovmr_tpu_torch.ops import cuda_lib

    image = torch.randn(1, 3, 224, 224, generator=torch.Generator().manual_seed(13))
    labels = torch.tensor([2])
    results = {}
    for device in ("cuda", "cpu"):
        trainer = coop_trainer(torch, 4, device, "float32")
        ctx = trainer.params["ctx"]
        step = trainer.optimizer.step
        grads = []
        trainer.optimizer.step = lambda: (grads.append(ctx.grad.detach().cpu()), step())
        cuda_lib.reset_launches()
        t = time.perf_counter()
        loss, _ = trainer.train_step(image.to(device), labels.to(device), 0)
        loss = float(loss)
        print(f"[fp32-coop] {device}: one step {time.perf_counter() - t:.2f} s, loss {loss:.6f}",
              flush=True)
        if device == "cuda":
            want = dict(coop_step_launches(trainer.clip_cfg, 3), gemm_wgmma=0,
                        attn_bwd_core_short=0, attn_bwd_core_tiled=36)
            if dict(cuda_lib.LAUNCHES) != want:
                raise AssertionError(f"fp32 CoOp step: launches {dict(cuda_lib.LAUNCHES)}, "
                                     f"expected {want}")
        results[device] = (loss, grads[0])
        del trainer
    (g_loss, g_grad), (c_loss, c_grad) = results["cuda"], results["cpu"]
    scale = max(float(c_grad.abs().max()), 1e-12)
    rel = float((g_grad - c_grad).abs().max()) / scale
    print(f"[fp32-coop] card vs CPU: loss {abs(g_loss - c_loss):.3g} (tol 1e-4), ctx gradient "
          f"{rel:.3g} of its scale (tol 1e-4)", flush=True)
    if not (abs(g_loss - c_loss) <= 1e-4 and rel <= 1e-4):
        raise AssertionError(f"fp32 CoOp step: loss {g_loss} vs {c_loss}, gradient {rel}")
    return abs(g_loss - c_loss), rel


def stage2_phase(torch, np, work):
    """Phase 14: the stage-2 runs, the 1000-class step and the fp32 check.
    Returns the launches of the entry-point runs and of the timed 1000-class
    steps, each with their launches by shape."""
    runs = stage2_runs(torch, np, work)
    torch.cuda.empty_cache()
    imagenet = imagenet_stage2_steps(torch)
    fp32_coop_step(torch)
    return runs, imagenet


# ---------------------------------------------------------------------------
# phase 15: zero-shot, clip_compat and the infer CLI
# ---------------------------------------------------------------------------

ZS_TEST_BATCH = 100  # the stage-2 yaml's test batch, so phase 2's vision-100 rows hold


def infer_runs(work):
    """``python -m ovmr_tpu_torch.infer`` as three processes at once over 32
    of phase 12's PNGs with phase 12's ``mm_classifiers.pt``: on the card in
    bf16 (the default), on the card in fp32, on the CPU in fp32. The fp32
    runs' top-5 labels must be equal and their scores within 1e-4."""
    data = work / "data" / "synthetic" / f"c{TRAINER_CLASSES}_n16_s224"
    args = [str(data / "000"), str(data / "001"), "--classifiers",
            str(work / "trainer" / "eval_out" / "mm_classifiers.pt"), "--clip", "ViT-B/16"]
    runs = {"cuda-bf16": [], "cuda-fp32": ["--dtype", "float32"],
            "cpu-fp32": ["--device", "cpu", "--dtype", "float32"]}
    t = time.perf_counter()
    procs = {name: subprocess.Popen([sys.executable, "-m", "ovmr_tpu_torch.infer"] + args + extra,
                                    cwd=str(ROOT), stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
             for name, extra in runs.items()}
    lines = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"infer {name} exited {proc.returncode}: {stderr[-2000:]}")
        lines[name] = [json.loads(x) for x in stdout.splitlines() if x.startswith("{")]
        if len(lines[name]) != 32:
            raise AssertionError(f"infer {name}: {len(lines[name])} lines, not 32")
        for row in lines[name]:
            scores = [p["score"] for p in row["predictions"]]
            if len(scores) != 5 or not all(math.isfinite(x) for x in scores):
                raise AssertionError(f"infer {name}: {row}")
    wall = time.perf_counter() - t
    card, cpu, bf16 = lines["cuda-fp32"], lines["cpu-fp32"], lines["cuda-bf16"]
    err = 0.0
    for a, b in zip(card, cpu):
        if a["image"] != b["image"] or [p["label"] for p in a["predictions"]] != [
                p["label"] for p in b["predictions"]]:
            raise AssertionError(f"infer top-5 on the card {a} differs from the CPU's {b}")
        err = max(err, max(abs(p["score"] - q["score"])
                           for p, q in zip(a["predictions"], b["predictions"])))
    if err > 1e-4:
        raise AssertionError(f"infer scores card vs CPU differ by {err}")
    top1 = sum(a["predictions"][0]["label"] == b["predictions"][0]["label"]
               for a, b in zip(bf16, cpu))
    print(f"[infer] three processes in {wall:.1f} s: fp32 card vs CPU the same top-5 labels for "
          f"all 32 images, scores within {err:.3g} (tol 1e-4); bf16 card top-1 equal to the "
          f"fp32 CPU's for {top1} of 32", flush=True)


def zeroshot_phase(torch, np, work):
    """Phase 15: ``ZeroshotCLIP2`` through ``ovmr_tpu_torch.train.main`` over
    phase 12's 192 classes (7 SELECT templates + the custom one, then the
    test pass), ``clip_compat.load("ViT-B/16")`` in smoke mode (a bf16
    contrastive forward of 100 preprocessed PNGs x 192 prompts with exact
    launches; fp32 logits card vs CPU within 1e-4) and the infer CLI.
    Returns the launches of the zero-shot run and those of the bf16
    clip_compat forward, each with launches by shape and each read with the
    counts zeroed just before."""
    import os

    from PIL import Image

    from ovmr_tpu_torch import clip_compat
    from ovmr_tpu_torch import train as entry
    from ovmr_tpu_torch.engine import zsclip
    from ovmr_tpu_torch.models import clip as tclip
    from ovmr_tpu_torch.ops import cuda_lib

    cfg = tclip.VIT_B16
    n_test = TRAINER_CLASSES * 4
    out = work / "zeroshot"
    argv = ["--root", str(work / "data"), "--seed", "1", "--trainer", "ZeroshotCLIP2",
            "--output-dir", str(out), "DATASET.NAME", "Synthetic", "DATASET.NUM_SHOTS",
            str(STAGE2_SHOTS), "MODEL.BACKBONE.NAME", "ViT-B/16", "INPUT.SIZE", "(224, 224)",
            "INPUT.INTERPOLATION", "bicubic", "INPUT.TRANSFORMS", "['normalize']",
            "DATALOADER.TEST.BATCH_SIZE", str(ZS_TEST_BATCH), "DATALOADER.NUM_WORKERS", "8",
            "CUDA.DTYPE", "bfloat16", "CUDA.DEVICE", "cuda"]
    rec = Recorder(torch)
    rec.wrap(zsclip.ZeroshotCLIP, "build_model")
    rec.wrap(zsclip.ZeroshotCLIP, "test")
    os.environ["OVMR_SYNTHETIC"] = f"{TRAINER_CLASSES},16,224"
    try:
        cuda_lib.reset_launches()
        t = time.perf_counter()
        trainer = run_entry(entry.build_parser(), entry, argv)
        zs_s = time.perf_counter() - t
    finally:
        rec.restore()
        os.environ.pop("OVMR_SYNTHETIC")
    templates = trainer.get_templates()
    if type(trainer) is not zsclip.ZeroshotCLIP2 or len(templates) != 8:
        raise AssertionError(f"zero-shot: {type(trainer).__name__} with {len(templates)} templates")
    if trainer.text_classifier.shape != (TRAINER_CLASSES, cfg.embed_dim):
        raise AssertionError(f"zero-shot text classifier {trainer.text_classifier.shape}")
    batches = -(-n_test // ZS_TEST_BATCH)
    text, vision = len(templates) * cfg.transformer_layers, batches * cfg.vision_layers
    want = {"fused_attn_half": vision, "fused_attn_half_masked": text,
            "fused_mlp_half": vision + text, "attn_core": vision + text}
    got = {k: cuda_lib.LAUNCHES[k] for k in want}
    if got != want:
        raise AssertionError(f"zero-shot launches {got}, expected {want}")
    log = (out / "log.txt").read_text()
    result = log[log.index("=> result"):].splitlines()[:6] if "=> result" in log else []
    if f"* total: {n_test:,}" not in result or "running test()" not in log:
        raise AssertionError(f"the zero-shot run did not test {n_test} images: {result}")
    zeroshot = dict(cuda_lib.LAUNCHES), dict(cuda_lib.LAUNCH_SHAPES)
    del trainer

    # clip_compat: the bf16 forward on the main path (towers random from seed 0)
    data = work / "data" / "synthetic" / f"c{TRAINER_CLASSES}_n16_s224"
    pngs = [data / f"{c:03d}" / f"{i:04d}.png" for c in range(25) for i in range(4)]
    names = [f"a photo of a {VOCAB[i % len(VOCAB)]} {i}." for i in range(TRAINER_CLASSES)]
    os.environ.pop("OVMR_CLIP_CKPT", None)
    t = time.perf_counter()
    model, preprocess = clip_compat.load("ViT-B/16")
    load_s = time.perf_counter() - t
    images = np.stack([preprocess(Image.open(p)) for p in pngs])
    tokens = clip_compat.tokenize(names)
    cuda_lib.reset_launches()
    t = time.perf_counter()
    lpi, lpt = model(images, tokens)
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t) * 1e3
    if (tuple(lpi.shape) != (100, TRAINER_CLASSES) or not torch.equal(lpi.T, lpt)
            or not bool(torch.isfinite(lpi).all()) or model.dtype != torch.bfloat16):
        raise AssertionError(f"clip_compat bf16 logits {tuple(lpi.shape)} {lpi.dtype}")
    compat = dict(cuda_lib.LAUNCHES), dict(cuda_lib.LAUNCH_SHAPES)
    # each tower once: K1 (K1-causal for the text) and K2 a layer, one
    # attention core inside each K1 and two wgmma GEMMs inside each K1 and K2
    v, tl = cfg.vision_layers, cfg.transformer_layers
    vision, text = (len(pngs), cfg.num_patches + 1, cfg.vision_width), (
        TRAINER_CLASSES, cfg.context_length, cfg.transformer_width)
    want_shapes = {
        ("fused_attn_half", vision, "bfloat16"): v,
        ("attn_core", vision + (cfg.vision_heads,), "bfloat16"): v,
        ("fused_mlp_half", vision, "bfloat16"): v,
        ("fused_attn_half_masked", text, "bfloat16"): tl,
        ("attn_core", text + (cfg.transformer_heads,), "bfloat16"): tl,
        ("fused_mlp_half", text, "bfloat16"): tl,
    }
    want = {k: 0 for k in compat[0]}
    want.update(fused_attn_half=v, fused_attn_half_masked=tl, attn_core=v + tl,
                fused_mlp_half=v + tl, gemm_wgmma=4 * (v + tl))
    if compat != (want, want_shapes):
        raise AssertionError(f"clip_compat forward: launches {compat[0]} by shape {compat[1]}, "
                             f"expected {want} by shape {want_shapes}")
    del model
    # fp32 on the card against the CPU, 2 images x 4 prompts
    logits = {}
    for device in ("cuda", "cpu"):
        m, _ = clip_compat.load("ViT-B/16", dtype=torch.float32, device=device)
        logits[device] = (m(images[:2], tokens[:4])[0].cpu(),
                          m.encode_image(images[:2]).float().cpu())
        del m
    err = float((logits["cuda"][0] - logits["cpu"][0]).abs().max())
    ferr = float((logits["cuda"][1] - logits["cpu"][1]).abs().max())
    smi = nvidia_smi_line()
    print(f"[zeroshot] ({smi}) ZeroshotCLIP2 through the entry point: {zs_s:.1f} s (classifier "
          f"of {len(templates)} templates x {TRAINER_CLASSES} classes "
          f"{rec.times['build_model'][0]:.2f} s, test {rec.times['test'][0]:.2f} s over {n_test} "
          f"images); {' '.join(result[1:3])}", flush=True)
    print(f"[clip_compat] ({smi}) load('ViT-B/16') {load_s:.1f} s; bf16 forward of 100 images x "
          f"{TRAINER_CLASSES} prompts {fwd_ms:.1f} ms (first call), exact launches {want}; "
          f"fp32 card vs CPU logits {err:.3g} (tol 1e-4), image features {ferr:.3g}", flush=True)
    if not err <= 1e-4:
        raise AssertionError(f"clip_compat fp32 logits card vs CPU differ by {err}")
    infer_runs(work)
    return zeroshot, compat


# ---------------------------------------------------------------------------
# phase 16: the ModifiedResNet towers
# ---------------------------------------------------------------------------

def resnet_work(cfg, batch, itemsize):
    """FLOPs and bytes of the ModifiedResNet image tower on ``batch`` images
    at its native resolution: every convolution's 2 Cout Cin k^2 Hout Wout,
    the attention pool's projections (one query token) and its attention;
    the weights read once, the images read, the features written."""
    r, w = cfg.image_resolution, cfg.vision_width
    flops = weights = 0

    def conv(cin, cout, k, side):
        nonlocal flops, weights
        flops += 2 * cout * cin * k * k * side * side
        weights += cout * cin * k * k

    side = r // 2  # the stem's stride-2 convolution
    conv(3, w // 2, 3, side)
    conv(w // 2, w // 2, 3, side)
    conv(w // 2, w, 3, side)
    side //= 2  # the stem's average pool
    inplanes = w
    for i, n_blocks in enumerate(cfg.vision_layers):
        planes = w * 2 ** i
        for b in range(n_blocks):
            out_side = side // (2 if i > 0 and b == 0 else 1)
            conv(inplanes, planes, 1, side)
            conv(planes, planes, 3, side)
            conv(planes, planes * 4, 1, out_side)  # after the pool
            if b == 0:
                conv(inplanes, planes * 4, 1, out_side)  # downsample: pool, then 1 x 1
            inplanes, side = planes * 4, out_side
    c, tokens = w * 32, side * side + 1
    flops += 2 * c * c * (1 + 2 * tokens) + 2 * c * cfg.embed_dim + 4 * tokens * c
    weights += 3 * c * c + c * cfg.embed_dim + tokens * c
    moved = (weights + batch * 3 * r * r + batch * cfg.embed_dim) * itemsize
    return batch * flops, moved


def text_launches(cfg, runs, dtype, batch):
    """Launches by kernel and by shape of ``runs`` bf16 passes of the causal
    text tower over ``batch`` prompts (K1-causal and K2 a layer, an attention
    core in each K1, two wgmma GEMMs in each K1 and K2)."""
    n = runs * cfg.transformer_layers
    text = (batch, cfg.context_length, cfg.transformer_width)
    by_name = dict(fused_attn_half_masked=n, fused_mlp_half=n, attn_core=n,
                   gemm_wgmma=4 * n if dtype == "bfloat16" else 0)
    by_shape = {("fused_attn_half_masked", text, dtype): n,
                ("attn_core", text + (cfg.transformer_heads,), dtype): n,
                ("fused_mlp_half", text, dtype): n}
    return by_name, by_shape


def exact(what, launches, shapes, by_name, by_shape):
    """Every counted launch of a path is the one expected: by name (the
    kernels not named ran none) and by shape."""
    want = {k: 0 for k in launches}
    want.update(by_name)
    if launches != want or shapes != by_shape:
        raise AssertionError(f"{what}: launches {launches} by shape {shapes}, expected {want} "
                             f"by shape {by_shape}")


def resnet_clip_compat(torch, np, work):
    """``clip_compat.load("RN50")`` in smoke mode: the bf16 contrastive forward
    of 100 of phase 12's PNGs x 192 prompts (the image tower is convolutions
    and no K1; the text tower K1-causal and K2 twelve times each), and the
    fp32 logits of 2 images x 4 prompts on the card against the CPU within
    1e-4. Returns the bf16 forward's launches and launches by shape."""
    import os

    from PIL import Image

    from ovmr_tpu_torch import clip_compat
    from ovmr_tpu_torch.ops import cuda_lib

    data = work / "data" / "synthetic" / f"c{TRAINER_CLASSES}_n16_s224"
    pngs = [data / f"{c:03d}" / f"{i:04d}.png" for c in range(25) for i in range(4)]
    names = [f"a photo of a {VOCAB[i % len(VOCAB)]} {i}." for i in range(TRAINER_CLASSES)]
    os.environ.pop("OVMR_CLIP_CKPT", None)
    t = time.perf_counter()
    model, preprocess = clip_compat.load("RN50")
    load_s = time.perf_counter() - t
    cfg = model.cfg
    if not cfg.is_resnet or cfg.vision_layers != (3, 4, 6, 3):
        raise AssertionError(f"clip_compat.load('RN50') built {cfg}")
    images = np.stack([preprocess(Image.open(p)) for p in pngs])
    tokens = clip_compat.tokenize(names)
    model(images[:4], tokens[:4])  # warm-up: cuDNN's first calls
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    t = time.perf_counter()
    lpi, lpt = model(images, tokens)
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t) * 1e3
    if (tuple(lpi.shape) != (100, TRAINER_CLASSES) or not torch.equal(lpi.T, lpt)
            or not bool(torch.isfinite(lpi).all())):
        raise AssertionError(f"RN50 clip_compat logits {tuple(lpi.shape)}")
    launches, shapes = dict(cuda_lib.LAUNCHES), dict(cuda_lib.LAUNCH_SHAPES)
    exact("RN50 clip_compat forward", launches, shapes,
          *text_launches(cfg, 1, "bfloat16", TRAINER_CLASSES))
    del model
    logits = {}
    for device in ("cuda", "cpu"):
        m, _ = clip_compat.load("RN50", dtype=torch.float32, device=device)
        logits[device] = m(images[:2], tokens[:4])[0].cpu()
        del m
    err = float((logits["cuda"] - logits["cpu"]).abs().max())
    print(f"[rn50] ({nvidia_smi_line()}) clip_compat.load('RN50') {load_s:.1f} s; bf16 forward "
          f"of 100 images x {TRAINER_CLASSES} prompts {fwd_ms:.1f} ms, exact launches (no vision "
          f"K1); fp32 card vs CPU logits {err:.3g} (tol 1e-4)", flush=True)
    if not err <= 1e-4:
        raise AssertionError(f"RN50 clip_compat fp32 logits card vs CPU differ by {err}")
    return launches, shapes


def resnet_zeroshot(torch, work):
    """``ZeroshotCLIP2`` at RN50 through the entry point over phase 12's 192
    classes: 8 templates through the text tower (exact launches), the test
    pass through the convolutions. Returns its launches and by shape."""
    import os

    from ovmr_tpu_torch import train as entry
    from ovmr_tpu_torch.models import clip as tclip
    from ovmr_tpu_torch.ops import cuda_lib

    n_test = TRAINER_CLASSES * 4
    argv = ["--root", str(work / "data"), "--seed", "1", "--trainer", "ZeroshotCLIP2",
            "--output-dir", str(work / "rn50_zeroshot"), "DATASET.NAME", "Synthetic",
            "DATASET.NUM_SHOTS", str(STAGE2_SHOTS), "MODEL.BACKBONE.NAME", "RN50",
            "INPUT.SIZE", "(224, 224)", "INPUT.INTERPOLATION", "bicubic",
            "INPUT.TRANSFORMS", "['normalize']", "DATALOADER.TEST.BATCH_SIZE",
            str(ZS_TEST_BATCH), "DATALOADER.NUM_WORKERS", "8", "CUDA.DTYPE", "bfloat16",
            "CUDA.DEVICE", "cuda"]
    os.environ["OVMR_SYNTHETIC"] = f"{TRAINER_CLASSES},16,224"
    try:
        cuda_lib.reset_launches()
        t = time.perf_counter()
        trainer = run_entry(entry.build_parser(), entry, argv)
        zs_s = time.perf_counter() - t
    finally:
        os.environ.pop("OVMR_SYNTHETIC")
    launches, shapes = dict(cuda_lib.LAUNCHES), dict(cuda_lib.LAUNCH_SHAPES)
    exact("RN50 ZeroshotCLIP2", launches, shapes,
          *text_launches(tclip.RN50, len(trainer.get_templates()), "bfloat16", TRAINER_CLASSES))
    if trainer.text_classifier.shape != (TRAINER_CLASSES, 1024):
        raise AssertionError(f"RN50 zero-shot classifier {trainer.text_classifier.shape}")
    log = (work / "rn50_zeroshot" / "log.txt").read_text()
    result = log[log.index("=> result"):].splitlines()[:6] if "=> result" in log else []
    if f"* total: {n_test:,}" not in result:
        raise AssertionError(f"the RN50 zero-shot run did not test {n_test} images: {result}")
    print(f"[rn50] ({nvidia_smi_line()}) ZeroshotCLIP2 at RN50 through the entry point: "
          f"{zs_s:.1f} s (8 templates x {TRAINER_CLASSES} classes, {n_test} test images); "
          f"{' '.join(result[1:3])}", flush=True)
    return launches, shapes


def resnet_coop(torch, np, work):
    """CoOp at RN50 through the entry point: ``configs/trainers/CoOp/
    vit_b16_c16_ep10_batch1.yaml`` with ``MODEL.BACKBONE.NAME RN50``, one
    epoch over phase 12's 192 classes at 1 shot (192 steps of batch 1) on
    phase 12's vokens, then its fusion eval. Every step's launches are
    exact (no vision K1: the image tower is convolutions). Returns the
    launches and by shape over the run, and the warm step's median wall."""
    import os

    from ovmr_tpu_torch import train as entry
    from ovmr_tpu_torch.engine import coop as coop_mod
    from ovmr_tpu_torch.models import clip as tclip
    from ovmr_tpu_torch.ops import cuda_lib

    vt_path = work / "trainer" / "eval_out" / "visual_tokens.pt"
    argv = ["--root", str(work / "data"), "--seed", "1", "--trainer", "CoOp",
            "--config-file", str(ROOT / COOP_YAML), "--visual_token_path", str(vt_path),
            "--output-dir", str(work / "rn50_coop"), "DATASET.NAME", "Synthetic",
            "DATASET.NUM_SHOTS", str(STAGE2_SHOTS), "MODEL.BACKBONE.NAME", "RN50",
            "CUDA.DEVICE", "cuda", "OPTIM.MAX_EPOCH", "1"]
    expected = coop_step_launches(tclip.RN50, 3)
    steps = []
    rec = Recorder(torch)

    def before_step(trainer, batch):
        rec.before = dict(cuda_lib.LAUNCHES)

    def after_step(trainer, batch, out):
        now = dict(cuda_lib.LAUNCHES)
        got = {k: now[k] - rec.before[k] for k in now}
        if got != expected:
            raise AssertionError(f"RN50 CoOp step {len(steps)}: launches {got}, "
                                 f"expected {expected}")
        if not math.isfinite(out["loss"]):
            raise AssertionError(f"RN50 CoOp step {len(steps)}: loss {out['loss']}")
        steps.append(rec.times["forward_backward"][-1])

    rec.wrap(coop_mod.CoOp, "forward_backward", before=before_step, after=after_step)
    rec.wrap(coop_mod.CoOp, "test")
    os.environ["OVMR_SYNTHETIC"] = f"{TRAINER_CLASSES},16,224"
    try:
        cuda_lib.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        trainer = run_entry(entry.build_parser(), entry, argv)
        run_s = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        rec.restore()
        os.environ.pop("OVMR_SYNTHETIC")
    launches, shapes = dict(cuda_lib.LAUNCHES), dict(cuda_lib.LAUNCH_SHAPES)
    if not trainer.clip_cfg.is_resnet or len(steps) != TRAINER_CLASSES * STAGE2_SHOTS:
        raise AssertionError(f"RN50 CoOp: {trainer.clip_cfg}, {len(steps)} steps")
    for key in ("mm_classifier", "vision_classifier", "text_classifier"):
        v = trainer.classifiers[key]
        if v.shape != (TRAINER_CLASSES, 1024) or not np.isfinite(v).all():
            raise AssertionError(f"RN50 CoOp {key}: {v.shape}")
    if launches["fused_attn_half"] != 0:
        raise AssertionError("the RN50 CoOp run launched a vision K1")
    warm = sorted(steps[3:])
    median_ms = warm[len(warm) // 2] * 1e3
    print(f"[rn50] ({nvidia_smi_line()}) CoOp at RN50 through the entry point: {len(steps)} "
          f"steps + fusion eval in {run_s:.1f} s (test {rec.times['test'][0]:.2f} s); step wall "
          f"warm median {median_ms:.1f} ms ({warm[0] * 1e3:.1f}-{warm[-1] * 1e3:.1f}), exact "
          f"launches {expected}; peak device memory {peak:.2f} GiB", flush=True)
    return launches, shapes, median_ms


def resnet_serving(torch, np):
    """``OVMRGenerator.from_checkpoints("RN101")`` (smoke mode, bf16): one
    warm-up and two requests of 32 classes x 16 exemplars at 224, then
    ``classify()`` of 256 queries. The launches are exact: per request the
    text tower's three prompt sets (K1-causal 36, K2 36) and the aggregator
    (K6 4), no vision K1. Prints the image tower's device time per request
    beside its bound, the walls and peak memory. Returns the launches and
    by shape over the two requests and classify."""
    from ovmr_tpu_torch.api import OVMRGenerator
    from ovmr_tpu_torch.ops import cuda_lib

    t = time.perf_counter()
    gen = OVMRGenerator.from_checkpoints("RN101", n_ctx=2, dtype=torch.bfloat16, seed=0)
    print(f"[rn101] generator ready in {time.perf_counter() - t:.1f} s", flush=True)
    cfg = gen.clip_cfg
    if not cfg.is_resnet or cfg.vision_layers != (3, 4, 23, 3) or cfg.embed_dim != 512:
        raise AssertionError(f"from_checkpoints('RN101') built {cfg}")
    requests, queries = make_requests(torch, 3, cfg.image_resolution)
    gen.generate(*requests[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    walls, outs = [], []
    for names, images in requests[1:]:
        t = time.perf_counter()
        outs.append(gen.generate(names, images))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    t = time.perf_counter()
    probs = gen.classify(queries, outs[-1], mode="fusion")
    classify_ms = (time.perf_counter() - t) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches, shapes = dict(cuda_lib.LAUNCHES), dict(cuda_lib.LAUNCH_SHAPES)
    by_name, by_shape = text_launches(cfg, 2 * 3, "bfloat16", N_CLS)
    by_name["fused_attention"] = 2 * 4
    by_shape[("fused_attention", (N_CLS, cfg.embed_dim // 64, SHOTS + 2, 64), "bfloat16")] = 8
    exact("RN101 requests and classify", launches, shapes, by_name, by_shape)
    for out in outs:
        check_classifiers(np, out, N_CLS, cfg.embed_dim, 2, unit_tol=1e-2)
    if probs.shape != (N_QUERIES, N_CLS) or not np.isfinite(probs).all():
        raise AssertionError(f"RN101 classify {probs.shape}")
    # the image tower's device time over one request's 512 exemplars
    flat = requests[1][1].reshape(N_CLS * SHOTS, 3, cfg.image_resolution, cfg.image_resolution)
    wall_ms, busy_ms, rows = device_times(torch, lambda: gen.encode_images(flat))
    flops, moved = resnet_work(cfg, N_CLS * SHOTS, 2)
    b_ms, b_by = bound_ms(moved, flops, PEAK_BF16)
    smi = nvidia_smi_line()
    print(f"[rn101] ({smi}) requests of {N_CLS} x {SHOTS} at {cfg.image_resolution} px: "
          f"{', '.join(f'{w:.1f}' for w in walls)} ms wall; classify {N_QUERIES} queries "
          f"{classify_ms:.1f} ms; peak device memory {peak:.2f} GiB; exact launches {by_name}",
          flush=True)
    print(f"[rn101] ({smi}) image tower on {N_CLS * SHOTS} exemplars: device {busy_ms:.2f} ms "
          f"(wall {wall_ms:.1f} ms), bound {b_ms:.4f} ms ({b_by}; {flops / 1e12:.2f} TFLOP, "
          f"{moved / 1e6:.1f} MB)", flush=True)
    for ms, key, count in rows[:6]:
        print(f"[rn101]   {ms:8.2f} ms x{count:<4d} {key[:90]}", flush=True)
    del gen
    return launches, shapes


def resnet_phase(torch, np, work):
    """Phase 16: the RN towers at full width (seeded random, bf16):
    clip_compat at RN50, ZeroshotCLIP2 at RN50, CoOp at RN50, RN101
    serving, and the fp32 RN101 request at 2 x 2 card vs CPU. Returns the
    paths' launches."""
    from ovmr_tpu_torch.api import OVMRGenerator

    paths = {"rn50_clip_compat": resnet_clip_compat(torch, np, work)}
    torch.cuda.empty_cache()
    paths["rn50_zeroshot"] = resnet_zeroshot(torch, work)
    torch.cuda.empty_cache()
    *paths["rn50_coop"], _ = resnet_coop(torch, np, work)
    torch.cuda.empty_cache()
    paths["rn101_serving"] = resnet_serving(torch, np)
    torch.cuda.empty_cache()
    fp32_path(torch, np, "rn101-fp32", lambda device: OVMRGenerator.from_checkpoints(
        "RN101", n_ctx=2, dtype=torch.float32, device=device, seed=0),
        n_cls=2, shots=2, n_queries=4)
    return paths


# ---------------------------------------------------------------------------
# phase 17: int8 serving
# ---------------------------------------------------------------------------

INT8_COSINE_FLOOR = 0.99
# the int8 request: blocks replayed on the CPU from the card's inputs, where
# each quantizer's fp32 input, in units of its row's step, must be within
# this of the card's (an activation that rounds to the neighbouring step
# lies on a .5 boundary); end to end, the card's classifiers must lie this
# share of int8's own distance from the float towers closer to the CPU's
INT8_REPLAY_STEP = 1e-3
INT8_REQUEST_SHARE = 0.9


def dense_int8_checks(torch):
    """``dense_int8`` at ViT-B/16's four block shapes: on 4 images x 197
    tokens of fp32 input the card's int8 activations and int32 products
    equal the CPU's and the output is within 1e-6 of its scale; each timed
    on the card at the eval's 256 x 197 tokens in bf16 beside the bf16
    ``torch.matmul`` of the same shape (a yardstick, not a claim)."""
    from ovmr_tpu_torch.ops import quant

    gen = torch.Generator().manual_seed(17)
    for name, k, n in (("w_qkv", 768, 2304), ("w_out", 768, 768), ("c_fc_w", 768, 3072),
                       ("c_proj_w", 3072, 768)):
        x = torch.randn(4 * 197, k, generator=gen)
        q, s = quant.quantize_weight((torch.randn(k, n, generator=gen) * k ** -0.5).numpy())
        q, s = torch.from_numpy(q), torch.from_numpy(s)
        b = torch.randn(n, generator=gen) * 0.02
        xq, _ = quant.quantize_rows(x)
        xq_c, _ = quant.quantize_rows(x.cuda())
        same_q = torch.equal(xq_c.cpu(), xq)
        same_acc = torch.equal(quant.int_mm(xq_c, q.cuda()).cpu(), quant.int_mm(xq, q))
        ref = quant.dense_int8(x, q, s, b)
        got = quant.dense_int8(x.cuda(), q.cuda(), s.cuda(), b.cuda()).cpu()
        err = float((got - ref).abs().max())
        tol = 1e-6 * max(float(ref.abs().max()), 1.0)
        big = torch.randn(256 * 197, k, device="cuda").to(torch.bfloat16)
        qc, sc, bc = q.cuda(), s.cuda(), b.cuda()
        wb = torch.randn(k, n, device="cuda").to(torch.bfloat16)
        int8_ms = cuda_ms(lambda: quant.dense_int8(big, qc, sc, bc), 5)[0]
        mm_ms = cuda_ms(lambda: torch.matmul(big, wb), 5)[0]
        print(f"[int8] dense_int8 {name} [{4 * 197}, {k}] x [{k}, {n}]: int8 activations equal "
              f"{same_q}, int32 products equal {same_acc}, output {err:.3g} (tol {tol:.3g}); at "
              f"[{256 * 197}, {k}] bf16 {int8_ms:.4f} ms, bf16 torch.matmul {mm_ms:.4f} ms",
              flush=True)
        if not (same_q and same_acc and err <= tol):
            raise AssertionError(f"dense_int8 {name} card vs CPU: activations {same_q}, "
                                 f"products {same_acc}, output {err}")
        del big, wb


def int8_block_replay(torch, blocks, calls):
    """Replay each int8 block the card ran on the CPU from the card's block
    input, each ``dense_int8`` inside it forced to the card's output (which
    the per-call replay shows the CPU computes too). What is left to differ
    is the float work between the products (LayerNorm, attention, GELU,
    the residual sums): each quantizer's fp32 input must lie within
    ``INT8_REPLAY_STEP`` of a step of the card's, and the block's output
    must equal the card's. Returns the activations compared, those that
    round to another step on the two devices, and the largest distance in
    steps."""
    from ovmr_tpu_torch.ops import layers, quant

    dense_int8 = quant.dense_int8
    seen, flipped, worst = 0, 0, 0.0
    for x, p, n_head, mask, y, lo, hi in blocks:
        if hi - lo != 4:
            raise AssertionError(f"an int8 block made {hi - lo} dense_int8 calls, not 4")
        forced = iter(calls[lo:hi])

        def replay(xs, w_q, w_scale, b=None):
            nonlocal seen, flipped, worst
            x_card, w_card, _, _, y_card = next(forced)
            if not torch.equal(w_q, w_card):
                raise AssertionError("the replayed block reached another int8 weight")
            rows = xs.reshape(-1, xs.shape[-1]).float()
            u_cpu = rows / quant.quantize_rows(rows)[1]
            u_card = x_card.reshape(rows.shape).float() / quant.quantize_rows(
                x_card.reshape(rows.shape).float())[1]
            seen += u_cpu.numel()
            flipped += int((torch.round(u_cpu) != torch.round(u_card)).sum())
            worst = max(worst, float((u_cpu - u_card).abs().max()))
            return y_card

        quant.dense_int8 = replay
        try:
            with torch.inference_mode():
                got = layers.residual_attention_block(x, p, n_head, mask)
        finally:
            quant.dense_int8 = dense_int8
        if not torch.equal(got, y):
            raise AssertionError(f"an int8 block replayed on the CPU differs from the card's by "
                                 f"{float((got - y).abs().max())}")
    return seen, flipped, worst


def int8_phase(torch, np, work, bf16_eval):
    """Phase 17: the MM_CLS_OP fusion eval at ViT-B/16 with ``CUDA.INT8 True``
    over phase 12's epoch-3 checkpoint and data (192 classes) through the
    entry point: no K1/K2 launched (the int8 towers take torch math), K6
    four times; its classifiers against phase 12's bf16 ones by a row
    cosine floor; its generation wall beside phase 12's (``bf16_eval``, the
    same call). Then ``dense_int8`` card vs CPU, and an fp32-activation int8
    request at 4 x 4: each of its ``dense_int8`` calls replayed on the CPU
    from the card's input (within 1e-6 of scale), each of its blocks too
    (``int8_block_replay``), its classifiers card vs CPU closer than int8's
    own distance from the float towers. Returns the eval's launches and by
    shape."""
    import os

    from ovmr_tpu_torch import train as entry
    from ovmr_tpu_torch.api import OVMRGenerator
    from ovmr_tpu_torch.engine import trainer as trainer_mod
    from ovmr_tpu_torch.models import clip as tclip
    from ovmr_tpu_torch.models.aggregator import init_aggregator
    from ovmr_tpu_torch.ops import block_fused, cuda_lib, quant

    out = work / "int8" / "eval_out"
    argv = ["--root", str(work / "data"), "--seed", "1", "--trainer", "MM_CLS_OP",
            "--n_ctx", "2", "--output-dir", str(out), "--model-dir",
            str(work / "trainer" / "train_out"), "--load-epoch", "3", "--eval-only",
            "--eval_mode", "fusion", "--eval_tau", "10"] + FLAGSHIP_OPTS + [
            "INPUT.TRANSFORMS", repr(FLAGSHIP_TRANSFORMS), "DATASET.NAME", "Synthetic",
            "DATASET.NUM_SHOTS", str(TRAINER_SHOTS), "OPTIM.MAX_EPOCH", "3", "CUDA.INT8", "True"]
    rec = Recorder(torch)
    rec.wrap(trainer_mod, "collect_exemplar_features")
    rec.wrap(trainer_mod, "mm_generate_classifiers")
    rec.wrap(trainer_mod.MM_CLS_OP, "test")
    os.environ["OVMR_SYNTHETIC"] = f"{TRAINER_CLASSES},16,224"
    try:
        cuda_lib.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        evaluator = run_entry(entry.build_parser(), entry, argv)
        run_s = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        rec.restore()
        os.environ.pop("OVMR_SYNTHETIC")
    launches, shapes = dict(cuda_lib.LAUNCHES), dict(cuda_lib.LAUNCH_SHAPES)
    serving = evaluator.serving_params
    if (serving["visual"]["blocks"]["w_qkv"].dtype != torch.int8
            or serving["visual"]["blocks"]["w_qkv_scale"].dtype != torch.float32
            or evaluator.clip_params["visual"]["blocks"]["w_qkv"].dtype != torch.bfloat16):
        raise AssertionError("the int8 eval did not serve int8 towers beside float ones")
    want = {k: 0 for k in launches}
    want["fused_attention"] = 4
    if launches != want:
        raise AssertionError(f"the int8 eval launched {launches}, expected {want}")
    ours = torch.load(out / "mm_classifiers.pt", weights_only=False)
    ref = torch.load(work / "trainer" / "eval_out" / "mm_classifiers.pt", weights_only=False)
    cosines = {}
    for key in ("mm_classifier", "vision_classifier", "text_classifier"):
        a, b = ours[key].float(), ref[key].float()
        if a.shape != (TRAINER_CLASSES, 512) or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"int8 {key}: {tuple(a.shape)}")
        cosines[key] = float(((a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))).min())
    log = (out / "log.txt").read_text()
    result = log[log.index("=> result"):].splitlines()[:6] if "=> result" in log else []
    if f"* total: {TRAINER_CLASSES * 4:,}" not in result:
        raise AssertionError(f"the int8 eval did not score {TRAINER_CLASSES * 4} images: {result}")
    smi = nvidia_smi_line()
    enc_s, gen_s = rec.times["collect_exemplar_features"][0], rec.times["mm_generate_classifiers"][0]
    print(f"[int8] ({smi}) MM_CLS_OP eval with CUDA.INT8 over phase 12's epoch 3: {run_s:.1f} s; "
          f"exemplar encode {enc_s:.2f} s (bf16, phase 12: {bf16_eval[0]:.2f} s), generation "
          f"{gen_s:.2f} s (bf16: {bf16_eval[1]:.2f} s), test {rec.times['test'][0]:.2f} s; peak "
          f"{peak:.2f} GiB; launches {dict((k, v) for k, v in launches.items() if v)}; "
          f"{' '.join(result[1:3])}", flush=True)
    print(f"[int8] ({smi}) classifiers against phase 12's bf16 ones, least row cosine: "
          f"{', '.join(f'{k} {v:.5f}' for k, v in cosines.items())} (floor {INT8_COSINE_FLOOR})",
          flush=True)
    if min(cosines.values()) < INT8_COSINE_FLOOR:
        raise AssertionError(f"int8 classifiers fall below the cosine floor: {cosines}")
    del evaluator, serving

    dense_int8_checks(torch)

    # an int8 request with fp32 activations at 4 classes x 4 exemplars. Every
    # dense_int8 call on the card is replayed on the CPU with the same fp32
    # input: equal int8 activations and int32 products give outputs within
    # 1e-6 of scale. Every block is replayed on the CPU from the card's
    # input (int8_block_replay). End to end the card and the CPU agree to
    # the quantizer's rounding, which the replay shows: closer than int8 to
    # the float towers (INT8_REQUEST_SHARE)
    cfg = tclip.VIT_B16
    qparams = quant.quantize_params(tclip.init_params(cfg, seed=0))
    agg = init_aggregator(width=cfg.embed_dim, n_ctx=2, seed=0)
    names = VOCAB[:4]
    images = exemplar_images(torch, 4, 4, 300, "cpu")
    outs, calls, blocks = {}, [], []
    dense_int8 = quant.dense_int8
    int8_block = block_fused.residual_attention_block

    def cpu(t):
        return None if t is None else t.detach().cpu()

    def recording(x, w_q, w_scale, b=None):
        y = dense_int8(x, w_q, w_scale, b)
        calls.append(tuple(cpu(t) for t in (x, w_q, w_scale, b, y)))
        return y

    def recording_block(x, p, n_head, mask=None):
        lo = len(calls)
        y = int8_block(x, p, n_head, mask)
        blocks.append((cpu(x), {k: cpu(v) for k, v in p.items()}, n_head, cpu(mask), cpu(y),
                       lo, len(calls)))
        return y

    for device in ("cuda", "cpu"):
        gen = OVMRGenerator(qparams, cfg, agg, dtype=torch.float32, device=device)
        cuda_lib.reset_launches()
        if device == "cuda":
            quant.dense_int8 = recording
            block_fused.residual_attention_block = recording_block
        try:
            outs[device] = gen.generate(names, images)
        finally:
            quant.dense_int8 = dense_int8
            block_fused.residual_attention_block = int8_block
        if device == "cuda":
            torch.cuda.synchronize()
            used = {k: v for k, v in cuda_lib.LAUNCHES.items() if v}
            if used != {"fused_attention": 4}:
                raise AssertionError(f"the int8 request launched {used}")
        del gen
    # the same request through the float towers on the CPU: int8's own
    # distance from float, beside the card's from the CPU
    gen = OVMRGenerator(tclip.init_params(cfg, seed=0), cfg, agg, dtype=torch.float32,
                        device="cpu")
    outs["float"] = gen.generate(names, images)
    del gen
    # the vision tower once, the text tower over the text, mm and v prompt
    # sets: 4 towers x 12 blocks x 4 products
    if len(calls) != 4 * 12 * 4 or len(blocks) != 4 * 12:
        raise AssertionError(f"the int8 request made {len(calls)} dense_int8 calls in "
                             f"{len(blocks)} blocks, not 192 in 48")
    replay = max(float((dense_int8(x, w, sc, b) - y).abs().max()) / max(float(y.abs().max()), 1.0)
                 for x, w, sc, b, y in calls)
    seen, flipped, worst = int8_block_replay(torch, blocks, calls)

    def apart(a, b):
        cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))
        return float(np.abs(a - b).max()), 1.0 - float(cos.min())

    keys = ("mm_classifier", "vision_classifier", "text_classifier")
    errs = {k: apart(outs["cuda"][k], outs["cpu"][k]) for k in keys}
    own = {k: apart(outs["cpu"][k], outs["float"][k]) for k in keys}
    print(f"[int8] fp32-activation int8 request at 4 x 4: its {len(calls)} dense_int8 calls "
          f"replayed on the CPU from the card's inputs within {replay:.3g} of scale (tol 1e-6); "
          f"its {len(blocks)} blocks replayed on the CPU from the card's inputs: outputs equal, "
          f"the quantizers' inputs within {worst:.3g} of a step of the card's (tol "
          f"{INT8_REPLAY_STEP}), {flipped} of {seen} activations on a .5 boundary rounded to "
          f"the neighbouring step", flush=True)
    print(f"[int8] classifiers card vs CPU (max abs, 1 - least row cosine): "
          f"{', '.join(f'{k} {e:.3g} {c:.3g}' for k, (e, c) in errs.items())}; int8 vs float on "
          f"the CPU: {', '.join(f'{k} {e:.3g} {c:.3g}' for k, (e, c) in own.items())} (card vs "
          f"CPU must stay below {INT8_REQUEST_SHARE} of it)", flush=True)
    if replay > 1e-6:
        raise AssertionError(f"dense_int8 on the card differs from its CPU replay by {replay}")
    if not worst <= INT8_REPLAY_STEP:
        raise AssertionError(f"an int8 block's quantizer input on the card is {worst} of a step "
                             "from the CPU's")
    for k in keys:
        if not (errs[k][0] < INT8_REQUEST_SHARE * own[k][0]
                and errs[k][1] < INT8_REQUEST_SHARE * own[k][1]):
            raise AssertionError(f"int8 request {k} card vs CPU {errs[k]} is not within "
                                 f"{INT8_REQUEST_SHARE} of int8's distance from float {own[k]}")
    return launches, shapes


# ---------------------------------------------------------------------------
# phase 18: the multi-resolution collate
# ---------------------------------------------------------------------------

MULTIRES_CLASSES, MULTIRES_INS = 48, 4


def multires_trainer(torch, work):
    """MM_CLS_OP with phase 12's recipe and ``DATALOADER.MULTI_RES_COLLATE
    True``, built through the entry point (``--no-train``) over phase 12's
    data; the batch cut to 48 classes x 4 instances."""
    from ovmr_tpu_torch import train as entry

    opts = list(FLAGSHIP_OPTS)
    for key, value in (("DATALOADER.TRAIN_X.BATCH_SIZE", str(MULTIRES_CLASSES * MULTIRES_INS)),
                       ("DATALOADER.TRAIN_X.N_INS", str(MULTIRES_INS))):
        opts[opts.index(key) + 1] = value
    argv = ["--root", str(work / "data"), "--seed", "1", "--trainer", "MM_CLS_OP", "--n_ctx",
            "2", "--no-train", "--output-dir", str(work / "multires")] + opts + [
            "INPUT.TRANSFORMS", "['normalize']", "DATASET.NAME", "Synthetic",
            "DATASET.NUM_SHOTS", str(TRAINER_SHOTS), "DATALOADER.MULTI_RES_COLLATE", "True"]
    return run_entry(entry.build_parser(), entry, argv)


def multires_step(torch, trainer, batch, expected):
    """One trainer step on ``batch``, its launches exact; returns the step's
    wall (s), the K1 launches at the batch's token count and peak memory."""
    from ovmr_tpu_torch.ops import cuda_lib

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    t = time.perf_counter()
    out = trainer.forward_backward(batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    got = dict(cuda_lib.LAUNCHES)
    if got != expected or not math.isfinite(out["loss"]):
        raise AssertionError(f"multires step: launches {got} (expected {expected}), "
                             f"loss {out['loss']}")
    tokens = (batch["img"].shape[2] // 16) * (batch["img"].shape[3] // 16) + 1
    k1 = sum(n for key, n in cuda_lib.LAUNCH_SHAPES.items()
             if key[0] == "fused_attn_half" and key[1][1] == tokens)
    return out["loss"], wall, k1, torch.cuda.max_memory_allocated() / 2 ** 30, tokens


def multires_phase(torch, np, work):
    """Phase 18: four steps from the seed of the collate's draws (each
    batch one drawn shape), every launch count exact and every loss finite;
    one drawn batch's fp32 image features card vs CPU within 1e-4; then the
    largest draw (672 x 1344, 3529 tokens) at two batch sizes, whose peak
    memory gives the largest batch that fits the card, and one step at
    nine tenths of it. Returns the four steps' launches and by shape."""
    import os

    from PIL import Image

    from ovmr_tpu_torch.data.multires import MultiResCollate
    from ovmr_tpu_torch.engine.trainer import encode_features
    from ovmr_tpu_torch.models import clip as tclip
    from ovmr_tpu_torch.ops import cuda_lib

    cfg = tclip.VIT_B16
    expected = train_step_launches(cfg)
    os.environ["OVMR_SYNTHETIC"] = f"{TRAINER_CLASSES},16,224"
    try:
        trainer = multires_trainer(torch, work)
        trainer.epoch = 0
        trainer.before_epoch()
        loader = iter(trainer.train_loader)
        batches = [next(loader) for _ in range(4)]
        loader.close()
    finally:
        os.environ.pop("OVMR_SYNTHETIC")
    smi = nvidia_smi_line()
    launches = {k: 0 for k in cuda_lib.LAUNCHES}
    shapes = {}

    def step(batch):
        """One step, its launches added to the phase's."""
        out = multires_step(torch, trainer, batch, expected)
        for k, v in cuda_lib.LAUNCHES.items():
            launches[k] += v
        for k, v in cuda_lib.LAUNCH_SHAPES.items():
            shapes[k] = shapes.get(k, 0) + v
        return out

    for i, batch in enumerate(batches):
        loss, wall, k1, peak, tokens = step(batch)
        h, w = batch["img"].shape[2:]
        print(f"[multires] ({smi}) step {i}: drawn {h} x {w} ({tokens} tokens), loss "
              f"{loss:.4f}, step wall {wall * 1e3:.1f} ms, K1 at {tokens} tokens x{k1}, peak "
              f"{peak:.2f} GiB", flush=True)
    # fp32 features of one drawn batch (the fewest tokens of the four), an
    # image pass of 96 as the steps take it, card vs CPU
    small = min(batches, key=lambda b: b["img"].shape[2] * b["img"].shape[3])["img"][:96]
    params = tclip.init_params(cfg, seed=0)
    feats = {}
    for device in ("cuda", "cpu"):
        p = tclip.tree_to(params, device=device)
        cuda_lib.reset_launches()
        with torch.inference_mode():
            feats[device] = encode_features(p, cfg, torch.from_numpy(small).to(device),
                                            torch.float32).cpu()
        if device == "cuda":
            torch.cuda.synchronize()
            fp32_shapes = dict(cuda_lib.LAUNCH_SHAPES)
    err = float((feats["cuda"] - feats["cpu"]).abs().max())
    print(f"[multires] fp32 image features of {small.shape[0]} images of a drawn "
          f"{small.shape[2]} x {small.shape[3]} batch, card vs CPU: {err:.3g} (tol 1e-4)",
          flush=True)
    if not err <= 1e-4:
        raise AssertionError(f"multires fp32 features card vs CPU differ by {err}")

    # the largest draw at two batch sizes: bytes a class of 4 images adds
    largest = MultiResCollate(patch_size=16, short_sizes=(672,), ratio_range=(2.0, 2.0),
                              ratio_bins=1, flip_p=0.0)
    data = work / "data" / "synthetic" / f"c{TRAINER_CLASSES}_n16_s224"
    sizes = (8, 24)
    pils = [Image.open(data / f"{c:03d}" / f"{i:04d}.png").convert("RGB")
            for c in range(max(sizes)) for i in range(MULTIRES_INS)]
    images = largest(pils, random.Random(0))
    peaks = {}

    def largest_step(n):
        """A step of ``n`` images at the largest draw (the drawn batch's
        images repeated; classes repeat past the dataset's 192)."""
        n_cls = n // MULTIRES_INS
        batch = {"img": np.concatenate([images] * -(-n // len(images)))[:n],
                 "label": np.repeat(np.arange(n_cls) % TRAINER_CLASSES, MULTIRES_INS)}
        loss, wall, _, peaks[n], tokens = step(batch)
        print(f"[multires] ({smi}) largest draw 672 x 1344 ({tokens} tokens), {n_cls} classes "
              f"x {MULTIRES_INS}: loss {loss:.4f}, step wall {wall * 1e3:.1f} ms, peak "
              f"{peaks[n]:.2f} GiB", flush=True)

    for n_cls in sizes:
        largest_step(n_cls * MULTIRES_INS)
    (n0, p0), (n1, p1) = sorted(peaks.items())
    per_image = (p1 - p0) / (n1 - n0)
    total = torch.cuda.get_device_properties(0).total_memory / 2 ** 30
    fits = int((total - (p0 - per_image * n0)) / per_image) // MULTIRES_INS * MULTIRES_INS
    print(f"[multires] ({smi}) at 3529 tokens a step adds {per_image * 1024:.1f} MiB an image: "
          f"the largest batch that fits {total:.1f} GiB is ~{fits} images "
          f"({fits // MULTIRES_INS} classes x {MULTIRES_INS}; linear in the two steps)",
          flush=True)
    # and a step at nine tenths of it, measured
    largest_step(int(0.9 * fits) // MULTIRES_INS * MULTIRES_INS)
    del trainer
    return (launches, shapes), fp32_shapes


# ---------------------------------------------------------------------------
# phase 19: the data axis
# ---------------------------------------------------------------------------

DATA_SHARDS = 4
DATA_SPLIT = 4
GEN_CLASSES, GEN_SHOTS = 1000, 16  # 16000 exemplar rows: the fusion streams


class SgdOptim(FlagshipOptim):
    """sgd at lr 1, no momentum or decay: an update linear in the gradient,
    large enough to compare two steps' updates leaf by leaf."""
    NAME = "sgd"
    LR = 1.0
    MOMENTUM = 0.0
    WEIGHT_DECAY = 0.0


def held_shape_checks(torch, cases, kernels, shapes, label):
    """Hold each kernel at every shape in ``shapes`` that no entry of
    ``kernels`` (phase 2 and the holds since) has held: K7/K8 (and the core
    inside K7), K6, then K1-K4 and the core."""
    def checked():
        return {entry["shape_key"] for entry in kernels}

    tp = {}
    for (name, shape, dtype) in shapes:
        if name.startswith("tp_") and (name, shape, dtype) not in checked():
            b, l, d, width = shape
            g = tp.setdefault((b, l, d, dtype), dict(masked=False, dl=None, hl=None))
            if name == "tp_mlp_half_partial":
                g["hl"] = width
            else:
                g["dl"], g["masked"] = width, name.endswith("_masked")
    for (b, l, d, dtype), g in sorted(tp.items()):
        if g["dl"] is None or g["hl"] is None:
            raise AssertionError(f"{label}: K7 and K8 did not both run at [{b}, {l}, {d}]")
        cases["tp"](f"{label}-tp-{l}-b{b}", b, l, d, g["dl"], g["dl"] // 64, g["hl"],
                    g["masked"], (getattr(torch, dtype),))
    for (name, shape, dtype) in sorted(shapes):
        if name == "fused_attention" and (name, shape, dtype) not in checked():
            n, h, l, dh = shape
            cases["attention"](f"{label}-aggregator-{n}-{l}", n, h, l, dh,
                               (getattr(torch, dtype),))
    tp_cores = {("attn_core", (b, l, g["dl"], g["dl"] // 64), dt)
                for (b, l, _, dt), g in tp.items()}
    drawn_block_checks(torch, cases["block"], checked() | tp_cores, shapes, label=label)


def data_axis_phase(torch, np, clip_params, agg_params, cases, kernels):
    """(a) The flagship step (ViT-B/16 bf16, 192 classes x 8, the
    device-augmentation path, dropout 0) at 4 local data shards against the
    single-program step with the same injected draws; (b) data 2 x model 2
    (K7/K8); (c) the process-group branch over NCCL at world size 1 against
    the local shard, bit for bit; (e) classifier generation and the fusion
    at 1000 classes x 16 shots on 4 local shards against one program.
    Returns the main path's launches of (a), (b) and (e)."""
    import socket

    import torch.distributed as dist

    from ovmr_tpu_torch.engine.optimizers import build_optimizer, param_leaves
    from ovmr_tpu_torch.engine.train_step import (
        make_sharded_train_step,
        make_train_step,
        slice_draws,
    )
    from ovmr_tpu_torch.engine.trainer import mm_generate_classifiers
    from ovmr_tpu_torch.models import clip as tclip
    from ovmr_tpu_torch.ops import cuda_lib
    from ovmr_tpu_torch.ops.augment import sample_augment_draws
    from ovmr_tpu_torch.ops.block_fused_tp import make_tp_block, split_clip_qkv
    from ovmr_tpu_torch.ops.fusion import (
        streaming_fusion_weights,
        streaming_fusion_weights_sharded,
    )
    from ovmr_tpu_torch.parallel import DataAxis, Mesh, ModelAxis, place_tower_params
    from ovmr_tpu_torch.utils import get_cfg_default

    t_phase = time.perf_counter()
    cfg = tclip.VIT_B16
    n_cls, n_ins, smi = TRAINER_CLASSES, TRAINER_SHOTS, nvidia_smi_line()
    towers = tclip.cast_params(tclip.tree_to(clip_params, device="cuda"), torch.bfloat16)
    inp = get_cfg_default().INPUT
    augment = dict(out_size=224, scale=tuple(inp.RRCROP_SCALE),
                   jitter=(inp.COLORJITTER_B, inp.COLORJITTER_C, inp.COLORJITTER_S,
                           inp.COLORJITTER_H),
                   gn_std=inp.GN_STD, mean=tuple(inp.PIXEL_MEAN), std=tuple(inp.PIXEL_STD),
                   out_dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(19)
    u8 = torch.randint(0, 256, (n_cls, n_ins, CACHE_SIDE, CACHE_SIDE, 3), dtype=torch.uint8,
                       device="cuda", generator=gen)
    draws = sample_augment_draws(gen, n_cls * n_ins, CACHE_SIDE,
                                 **{k: augment[k] for k in ("out_size", "scale", "jitter",
                                                            "gn_std")})
    ptok, eot, vtok = prompt_inputs(torch, np, n_cls, "cuda")
    flagship = (u8, ptok, eot, draws)
    names = leaf_names(agg_params)

    def run(step, params, shards, reps=1, inputs=None):
        """``reps`` steps, each from a fresh copy of the aggregator: the
        first's loss, update by leaf, launches and shapes; the walls and
        the peak memory. ``inputs``: ``(u8, ptok, eot, draws)``, by default
        the flagship batch's."""
        u8, ptok, eot, draws = inputs or flagship
        cut = draws if shards is None else slice_draws(draws, shards)
        walls, out = [], None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for i in range(reps):
            agg = trainable_aggregator(torch, agg_params, "cuda")
            before = [leaf.detach().clone() for leaf in param_leaves(agg)]
            optimizer = build_optimizer(SgdOptim, agg)
            cuda_lib.reset_launches()
            t = time.perf_counter()
            loss = step(agg, optimizer, params, u8, ptok, eot, vtok, None, DATA_SPLIT,
                        augment_draws=cut)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
            if i == 0:
                out = dict(loss=float(loss), launches=dict(cuda_lib.LAUNCHES),
                           shapes=dict(cuda_lib.LAUNCH_SHAPES),
                           update=[leaf.detach() - b for leaf, b in zip(param_leaves(agg),
                                                                         before)])
        out["walls"] = walls
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        return out

    def hold(tag, got, ref, exact=False, loss_tol=1e-2, abs_tol=1e-2, rel_tol=5e-2):
        """The bf16 ladder: the loss and each updated leaf within 1e-2; and,
        since an update at lr 1 is ~1e-2 itself, each leaf's update within 5%
        of the reference update in L2 (the aggregator's products run in bf16,
        so its gradient's sums round differently over 48 classes than over
        192; a double-counted cross-shard gradient is off by ~100%); or,
        ``exact``, both bit for bit."""
        if exact:
            same = got["loss"] == ref["loss"] and all(
                torch.equal(a, b) for a, b in zip(got["update"], ref["update"]))
            if not same:
                raise AssertionError(f"[data] {tag}: not bit for bit equal")
            print(f"[data] {tag}: loss {got['loss']!r}, every update bit for bit equal",
                  flush=True)
            return
        loss_err = abs(got["loss"] - ref["loss"])
        if not loss_err <= loss_tol:
            raise AssertionError(f"[data] {tag}: loss {got['loss']} vs {ref['loss']}")
        worst_abs, worst_rel = 0.0, 0.0
        for name, a, b in zip(names, got["update"], ref["update"]):
            err = float((a - b).abs().max())
            rel = float((a - b).norm() / b.norm()) if float(b.norm()) > 0 else math.inf
            print(f"[data]   {tag} {name}: update |d| {err:.3g}, L2 {rel:.3g} of "
                  f"{float(b.norm()):.3g}", flush=True)
            if not (err <= abs_tol and rel <= rel_tol):
                raise AssertionError(f"[data] {tag}: {name} update off by {err:.3g} "
                                     f"(L2 {rel:.3g} of the reference's)")
            worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
        print(f"[data] {tag}: loss {got['loss']:.6f} vs {ref['loss']:.6f} (|d| {loss_err:.3g}); "
              f"updates |d| <= {worst_abs:.3g}, L2 <= {worst_rel:.3g} of the reference's",
              flush=True)

    def exact_launches(tag, got, want):
        if got != want:
            raise AssertionError(f"[data] {tag}: launches {got}, expected {want}")

    # (a) one program, then 4 local data shards: each shard one program's
    # kernels at a quarter of the classes
    single = run(make_train_step(cfg, dropout=0.0, augment=augment), towers, None, reps=3)
    one = single["launches"]
    if one["fused_attn_half"] != 2 * cfg.vision_layers or one["fused_attention"] != 4:
        raise AssertionError(f"[data] single-program step launches {one}")
    mesh4 = Mesh(DataAxis.local(DATA_SHARDS), ModelAxis.local(1))
    sharded = run(make_sharded_train_step(cfg, mesh4, dropout=0.0, augment=augment), towers,
                  DATA_SHARDS, reps=3)
    exact_launches("4 local shards", sharded["launches"],
                   {k: DATA_SHARDS * n for k, n in one.items()})
    hold("4 local shards vs one program", sharded, single)
    for tag, r in (("one program", single), (f"{DATA_SHARDS} local shards", sharded)):
        print(f"[data] ({smi}) flagship step, {tag}: "
              f"{', '.join(f'{w:.1f}' for w in r['walls'])} ms; peak {r['peak_gib']:.2f} GiB",
              flush=True)
    for key, count in sorted(sharded["shapes"].items()):
        print(f"[data]   {key[0]} {list(key[1])} {key[2]}: {count}", flush=True)
    # the same comparison in fp32 on 48 of the classes: what is left of the
    # bf16 gap is fp32 rounding, so the sharded step's gradient is one
    # program's (a double count would be off by ~100% here too)
    aug32 = dict(augment, out_dtype=torch.float32)
    n32 = n_cls // DATA_SHARDS
    inputs32 = (u8[:n32], ptok[:n32], eot[:n32],
                {k: None if v is None else v[:n32 * n_ins] for k, v in draws.items()})
    towers32 = tclip.tree_to(clip_params, device="cuda")
    hold("fp32, 48 classes: 4 local shards vs one program",
         run(make_sharded_train_step(cfg, mesh4, dropout=0.0, augment=aug32), towers32,
             DATA_SHARDS, inputs=inputs32),
         run(make_train_step(cfg, dropout=0.0, augment=aug32), towers32, None, inputs=inputs32),
         loss_tol=1e-5, abs_tol=1e-5, rel_tol=1e-3)
    del towers32

    # (b) data 2 x model 2: K7/K8 in every block of both data shards
    model = ModelAxis.local(2)
    placed = place_tower_params(model, split_clip_qkv(towers, 2, cfg))
    mesh22 = Mesh(DataAxis.local(2), model)
    dm = run(make_sharded_train_step(cfg, mesh22, dropout=0.0, augment=augment,
                                     block_fn=make_tp_block(model)), placed, 2, reps=2)
    # a data shard: two image passes and two prompt sets, each layer's block
    # on both model shards
    k7_v, k7_t = 2 * 2 * cfg.vision_layers, 2 * 2 * cfg.transformer_layers
    want = {k: 0 for k in one}
    want.update(tp_attn_half_partial=2 * k7_v, tp_attn_half_partial_masked=2 * k7_t,
                tp_mlp_half_partial=2 * (k7_v + k7_t), attn_core=2 * (k7_v + k7_t),
                fused_attention=2 * 4, gemm_wgmma=2 * (4 + 2) * (k7_v + k7_t))
    exact_launches("data 2 x model 2", dm["launches"], want)
    hold("data 2 x model 2 vs one program", dm, single)
    print(f"[data] ({smi}) flagship step, data 2 x model 2: "
          f"{', '.join(f'{w:.1f}' for w in dm['walls'])} ms; peak {dm['peak_gib']:.2f} GiB",
          flush=True)
    del placed

    # (c) the process-group branch over NCCL at world size 1
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    try:
        grouped = Mesh(DataAxis(1, (0,), group=dist.group.WORLD), ModelAxis.local(1))
        step_g = make_sharded_train_step(cfg, grouped, dropout=0.0, augment=augment)
        local1 = Mesh(DataAxis.local(1), ModelAxis.local(1))
        hold("NCCL world size 1 vs local(1)", run(step_g, towers, 1),
             run(make_sharded_train_step(cfg, local1, dropout=0.0, augment=augment), towers, 1),
             exact=True)

        def one_step():
            agg = trainable_aggregator(torch, agg_params, "cuda")
            step_g(agg, build_optimizer(SgdOptim, agg), towers, u8, ptok, eot, vtok, None,
                   DATA_SPLIT, augment_draws=slice_draws(draws, 1))

        wall_ms, busy_ms, rows = device_times(torch, one_step)
        coll_ms = sum(ms for ms, key, _ in rows if "nccl" in key.lower())
        print(f"[data] ({smi}) NCCL world 1 step: wall {wall_ms:.1f} ms, device busy "
              f"{busy_ms:.1f} ms, NCCL kernels {coll_ms:.4f} ms "
              f"({100 * coll_ms / busy_ms:.3f}% of busy)", flush=True)
    finally:
        dist.destroy_process_group()

    # (e) generation and fusion at 1000 classes x 16 shots on 4 local shards
    g = torch.Generator().manual_seed(5)
    feats = torch.randn(GEN_CLASSES, GEN_SHOTS, cfg.embed_dim, generator=g)
    feats = (feats / feats.norm(dim=-1, keepdim=True)).numpy()
    ptok_g, eot_g, vtok_g = (a.numpy() for a in prompt_inputs(torch, np, GEN_CLASSES, "cpu"))
    agg_eval = {"blocks": {k: v.to("cuda") for k, v in agg_params["blocks"].items()},
                "cls_token": agg_params["cls_token"].to("cuda")}
    outs = {}
    for tag, mesh in (("one", None), ("sharded", mesh4)):
        cuda_lib.reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = mm_generate_classifiers(towers, cfg, agg_eval, feats, ptok_g, eot_g, vtok_g, 10.0,
                                      mesh=mesh)
        torch.cuda.synchronize()
        outs[tag] = dict(out=out, wall=(time.perf_counter() - t) * 1e3,
                         launches=dict(cuda_lib.LAUNCHES), shapes=dict(cuda_lib.LAUNCH_SHAPES))
    ref, got = outs["one"]["out"], outs["sharded"]["out"]
    exact_launches("sharded generation", outs["sharded"]["launches"],
                   {k: DATA_SHARDS * n for k, n in outs["one"]["launches"].items()})
    for key in ("mm_classifier", "vision_classifier", "text_classifier", "visual_tokens"):
        err = float(np.abs(got[key] - ref[key]).max())
        tol = tolerance(torch.bfloat16, torch.as_tensor(ref[key]))
        if not err <= tol:
            raise AssertionError(f"[data] sharded generation {key}: {err:.3g} > {tol:.3g}")
    # the fusion alone on one set of classifiers: the sharded scan's counts
    # are one scan's, bit for bit
    flat = torch.as_tensor(feats, device="cuda").to(torch.bfloat16).reshape(-1, cfg.embed_dim)
    labels = torch.arange(GEN_CLASSES, device="cuda").repeat_interleave(GEN_SHOTS)
    cls3 = [torch.as_tensor(ref[k], device="cuda") for k in
            ("mm_classifier", "vision_classifier", "text_classifier")]
    scale = float(clip_params["logit_scale"].float().exp())
    f_one = streaming_fusion_weights(flat, labels, cls3, scale, 10.0)
    f_sharded = streaming_fusion_weights_sharded(DataAxis.local(DATA_SHARDS), flat, labels, cls3,
                                                 scale, 10.0)
    if not torch.equal(f_one, f_sharded):
        raise AssertionError("[data] the sharded fusion differs from one program's")
    if not np.allclose(got["fusion_weight"].sum(-1), 1.0, atol=1e-5):
        raise AssertionError("[data] sharded generation: fusion weights do not sum to 1")
    fw_err = float(np.abs(got["fusion_weight"] - ref["fusion_weight"]).max())
    print(f"[data] ({smi}) generation at {GEN_CLASSES} x {GEN_SHOTS}: one program "
          f"{outs['one']['wall']:.1f} ms, {DATA_SHARDS} local shards "
          f"{outs['sharded']['wall']:.1f} ms; classifiers within 2 bf16 ulp, the fusion scan "
          f"bit for bit, end-to-end fusion weights |d| {fw_err:.3g}", flush=True)

    # every launch of the phase at a shape a check held
    shapes = {}
    for r in (sharded["shapes"], dm["shapes"], outs["sharded"]["shapes"], single["shapes"],
              outs["one"]["shapes"]):
        for key, n in r.items():
            shapes[key] = shapes.get(key, 0) + n
    held_shape_checks(torch, cases, kernels, shapes, "data-axis")
    print(f"[data] phase 19 in {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"data_axis": (sharded["launches"], sharded["shapes"]),
            "data_model": (dm["launches"], dm["shapes"]),
            "sharded_generation": (outs["sharded"]["launches"], outs["sharded"]["shapes"])}


def _gloo_rank(rank, world, work, transforms):
    """One rank of phase 19 (d): joins a gloo group of ``world`` ranks on
    the one card, then trains MM_CLS_OP for two epochs of one step through
    ``ovmr_tpu_torch.train.main`` over phase 12's data, its rows sliced by
    its data shard; saves its losses, rows and state for the parent."""
    import os

    sys.path.insert(0, str(ROOT))
    import torch
    import torch.distributed as dist

    from ovmr_tpu_torch import train as entry
    from ovmr_tpu_torch.engine import checkpoint as ckpt
    from ovmr_tpu_torch.engine import trainer as trainer_mod

    os.environ["OVMR_SYNTHETIC"] = f"{TRAINER_CLASSES},16,224"
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{work}/dist/rendezvous", rank=rank,
                            world_size=world)
    try:
        seen = []
        orig = trainer_mod.MM_CLS_OP.forward_backward

        def recording(self, batch):
            out = orig(self, batch)
            seen.append((out["loss"], bool(batch.get("_local", False)), len(batch["img"])))
            return out

        trainer_mod.MM_CLS_OP.forward_backward = recording
        argv = ["--root", f"{work}/data", "--seed", "1", "--trainer", "MM_CLS_OP", "--n_ctx", "2",
                "--output-dir", f"{work}/dist/rank{rank}"] + FLAGSHIP_OPTS + [
            "INPUT.TRANSFORMS", repr(transforms), "DATASET.NAME", "Synthetic",
            "DATASET.NUM_SHOTS", str(TRAINER_SHOTS), "OPTIM.MAX_EPOCH", "2", "TEST.NO_TEST",
            "True", "TRAIN.PRINT_FREQ", "1", "CUDA.MESH.DATA", str(world)]
        stdout = sys.stdout
        try:
            trainer = entry.main(entry.build_parser().parse_args(argv))
        finally:
            tee, sys.stdout = sys.stdout, stdout
            if tee is not stdout:
                tee.close()
        torch.save({"seen": seen,
                    "params": {k: v.detach().cpu() for k, v in
                               ckpt.named_leaves(trainer.agg_params)},
                    "opt": ckpt.optimizer_state_arrays(trainer.optimizer, trainer.agg_params),
                    "mesh": trainer.mesh.shape},
                   f"{work}/dist/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def gloo_ranks_phase(torch, work):
    """Phase 19 (d): two ranks share the card over gloo (NCCL refuses two
    ranks on one card) and train MM_CLS_OP for two steps with the sliced
    loader: each decodes its 96 classes of every 192-class batch, and both
    print the same losses and hold the same aggregator and adam state."""
    import importlib.util

    import torch.multiprocessing as mp

    t = time.perf_counter()
    transforms = (FLAGSHIP_TRANSFORMS if importlib.util.find_spec("PIL") is not None
                  else ["random_flip", "normalize"])
    (work / "dist").mkdir(exist_ok=True)
    mp.spawn(_gloo_rank, args=(2, str(work), transforms), nprocs=2, join=True)
    ranks = [torch.load(work / "dist" / f"rank{r}.pt", weights_only=False) for r in range(2)]
    half = TRAINER_CLASSES * TRAINER_SHOTS // 2
    for r, got in enumerate(ranks):
        if got["mesh"] != {"data": 2, "model": 1}:
            raise AssertionError(f"[gloo] rank {r}: mesh {got['mesh']}")
        if [(local, rows) for _, local, rows in got["seen"]] != [(True, half)] * 2:
            raise AssertionError(f"[gloo] rank {r}: batches {got['seen']}")
    losses = [[loss for loss, _, _ in got["seen"]] for got in ranks]
    if losses[0] != losses[1] or not all(math.isfinite(v) for v in losses[0]):
        raise AssertionError(f"[gloo] losses differ across the ranks: {losses}")
    for key, value in ranks[0]["params"].items():
        if not torch.equal(value, ranks[1]["params"][key]):
            raise AssertionError(f"[gloo] {key} differs across the ranks")
    for key, value in ranks[0]["opt"].items():
        if not (value == ranks[1]["opt"][key]).all():
            raise AssertionError(f"[gloo] optimizer {key} differs across the ranks")
    if not (work / "dist" / "rank0" / "prompt_learner" / "model-2.npz").is_file() or (
            work / "dist" / "rank1" / "prompt_learner" / "model-2.npz").exists():
        raise AssertionError("[gloo] the npz checkpoint was not written by rank 0 alone")
    print(f"[gloo] two ranks on one card over gloo: 2 MM_CLS_OP steps, {half} rows a rank a "
          f"step, losses {losses[0]} on both, aggregator and adam state bit for bit equal, "
          f"npz by rank 0 alone; {time.perf_counter() - t:.1f} s", flush=True)


def drawn_block_checks(torch, block_case, checked, *shape_sets, label="multires-drawn"):
    """Hold every block kernel at each ``(B, L, D, dtype)`` that phase 18
    (or 19) launched and phase 2 did not check: K1 (causal for the prompt
    sets, whose batch is the step's classes), its core and K2, with K3 and
    K4 where the step ran them. Where a plain version runs in slices (3529
    tokens), one round of one call each."""
    groups = {}
    for shapes in shape_sets:
        for name, shape, dtype in shapes:
            if (name, shape, dtype) in checked or name.removesuffix("_masked") not in (
                    "fused_attn_half", "attn_core", "fused_mlp_half", "attn_half_bwd_dx",
                    "mlp_half_bwd_dx"):
                continue
            b, l, d = shape[:3]
            g = groups.setdefault((b, l, d, dtype), dict(masked=False, bwd=False, heads=d // 64))
            g["masked"] |= name.endswith("_masked")
            g["bwd"] |= "bwd" in name
            if name == "attn_core":
                g["heads"] = shape[3]
    for (b, l, d, dtype), g in sorted(groups.items()):
        timed = dict(reps=1, rounds=1) if slice_step(b, g["heads"], l) < b else None
        block_case(f"{label}-{l}-b{b}", b, l, d, g["heads"], g["masked"],
                   (getattr(torch, dtype),), g["bwd"], timed)


# ---------------------------------------------------------------------------
# phase 20: the Dassl DG trainers at PACS's published recipes
# ---------------------------------------------------------------------------

PACS_DOMAINS = ("art_painting", "cartoon", "photo", "sketch")
PACS_CLASSES = ("dog", "elephant", "giraffe", "guitar", "horse", "house", "person")
PACS_TRAIN, PACS_VAL = 16, 4  # images a class a domain in each kfold split
PACS_SEED = 1
DG_SOURCES, DG_TARGET = ("art_painting", "cartoon", "photo"), "sketch"


def write_pacs(np, root: Path) -> int:
    """A PACS-layout tree (``pacs/images/<domain>/<class>/*.jpg`` at 227 x
    227, ``pacs/splits/<domain>_{train,crossval}_kfold.txt`` of ``relpath
    label`` lines, 1-based labels), drawn from :data:`PACS_SEED`: each class
    a colour and a stripe frequency, each domain a contrast, plus noise."""
    import concurrent.futures as cf

    from PIL import Image

    def save(pixels, path):
        Image.fromarray(pixels).save(path, quality=90)

    rng = np.random.default_rng(PACS_SEED)
    yy, xx = np.mgrid[0:227, 0:227] / 227.0
    jobs = []
    with cf.ThreadPoolExecutor(max_workers=8) as pool:  # the draws stay in order
        for d, domain in enumerate(PACS_DOMAINS):
            splits = {"train": [], "crossval": []}
            for c, cname in enumerate(PACS_CLASSES):
                cdir = root / "pacs" / "images" / domain / cname
                cdir.mkdir(parents=True, exist_ok=True)
                hue = np.array([(c * 37) % 255, (c * 91) % 255, (c * 53) % 255]) / 255.0
                stripes = np.sin((xx * (c + 2) + yy * (d + 1)) * 2 * np.pi)[..., None]
                for i in range(PACS_TRAIN + PACS_VAL):
                    img = 0.5 + (0.15 + 0.1 * d) * stripes * hue + rng.normal(0, 0.08,
                                                                          (227, 227, 3))
                    rel = f"{domain}/{cname}/{i:03d}.jpg"
                    jobs.append(pool.submit(save, (np.clip(img, 0, 1) * 255).astype(np.uint8),
                                            root / "pacs" / "images" / rel))
                    splits["train" if i < PACS_TRAIN else "crossval"].append(f"{rel} {c + 1}")
            sdir = root / "pacs" / "splits"
            sdir.mkdir(parents=True, exist_ok=True)
            for split, lines in splits.items():
                (sdir / f"{domain}_{split}_kfold.txt").write_text("\n".join(lines) + "\n")
        for job in jobs:
            job.result()
    return len(jobs)


def dg_argv(root: Path, out: Path, trainer: str, yaml=None, opts=()):
    """``python -m ovmr_tpu_torch.train`` arguments of a PACS run: the dataset
    yaml, the trainer's yaml (or Vanilla's, for the trainers without one),
    the sources and the target, and the run's cuts as options."""
    cfg_dir = ROOT / "configs"
    yaml = yaml or "vanilla"
    return ["--root", str(root), "--seed", str(PACS_SEED), "--trainer", trainer,
            "--dataset-config-file", str(cfg_dir / "datasets" / "dg" / "pacs.yaml"),
            "--config-file", str(cfg_dir / "trainers" / "dg" / yaml / "pacs.yaml"),
            "--output-dir", str(out),
            "DATASET.SOURCE_DOMAINS", repr(list(DG_SOURCES)),
            "DATASET.TARGET_DOMAINS", repr([DG_TARGET]),
            "DATALOADER.NUM_WORKERS", "8", *opts]


# run -> (trainer, its yaml, the cuts as options); DDAIG runs one epoch past
# its warmup (21 steps, each with its generator), as its gate steps
DG_RUNS = {
    "vanilla": ("Vanilla", "vanilla", ["OPTIM.MAX_EPOCH", "1"]),
    "ddaig": ("DDAIG", "ddaig", ["OPTIM.MAX_EPOCH", "1", "TRAINER.DDAIG.WARMUP", "0"]),
    "daeldg": ("DAELDG", "daeldg", ["OPTIM.MAX_EPOCH", "1"]),
    "crossgrad": ("CrossGrad", None, ["OPTIM.MAX_EPOCH", "1"]),
    "domainmix": ("DomainMix", None, ["OPTIM.MAX_EPOCH", "1"]),
    "vanilla_data2": ("Vanilla", "vanilla", ["OPTIM.MAX_EPOCH", "1", "CUDA.MESH.DATA", "2"]),
}


def dg_run(torch, np, root: Path, tag: str):
    """One PACS run through ``ovmr_tpu_torch.train.main`` on the card
    (:func:`dassl_entry_run`)."""
    from ovmr_tpu_torch.engine import dassl_base, dg

    name, yaml, opts = DG_RUNS[tag]
    wraps = [(cls, "forward_backward") for cls in (dassl_base.DasslTrainer, dg.CrossGrad,
                                                   dg.DDAIG, dg.DAELDG, dg.DomainMix)]
    return dassl_entry_run(torch, "dg", tag, root / tag, wraps,
                           dg_argv(root, root / tag, name, yaml, opts))


def dassl_entry_run(torch, prefix: str, tag: str, out: Path, wraps, argv):
    """One Dassl run through ``ovmr_tpu_torch.train.main`` on the card, its
    first epoch profiled (``OVMR_PROFILE_DIR``): the warm median step (the
    ``wraps``' methods, timed to a synchronise), the first epoch's wall, the
    last epoch's host data time, the card's busy share of the first epoch
    (:func:`device_busy_ms`) and of its warm steps (:func:`warm_busy_share`),
    peak memory and the K1-K8 launches (the counts zeroed just before). The
    test pass prints its ``=> result``."""
    import os
    import statistics

    from ovmr_tpu_torch import train as entry
    from ovmr_tpu_torch.ops import cuda_lib

    rec = Recorder(torch)
    label = f"{prefix}_step"
    for owner, method in wraps:
        rec.wrap(owner, method, label=label)
    os.environ["OVMR_PROFILE_DIR"] = str(out / "profile")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    t = time.perf_counter()
    try:
        trainer = run_entry(entry.build_parser(), entry, argv)
    finally:
        os.environ.pop("OVMR_PROFILE_DIR")
        rec.restore()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches, shapes = dict(cuda_lib.LAUNCHES), dict(cuda_lib.LAUNCH_SHAPES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = [v for method in dict.fromkeys(m for _, m in wraps) for v in rec.times.get(method, [])]
    if not steps:
        raise AssertionError(f"[{prefix}] {tag}: no training step ran")
    if any(launches.values()):
        raise AssertionError(f"[{prefix}] {tag} launched K1-K8: {launches}")
    prof, epoch_s = trainer.epoch_profile
    busy = device_busy_ms(torch, prof)
    warm_busy = warm_busy_share(torch, prof, label)
    per_epoch = trainer.num_batches
    # the first epoch's steps after its first (the profiler runs in all)
    warm = steps[1:per_epoch] if per_epoch > 1 else steps
    print(f"[{prefix}] {tag}: {len(steps)} steps ({per_epoch} an epoch), warm median step "
          f"{1e3 * statistics.median(warm):.1f} ms, first epoch {epoch_s:.2f} s (profiled), "
          f"last epoch's host data time {trainer.data_time.sum:.2f} s, card busy {busy:.0f} ms "
          f"= {100 * busy / (1e3 * epoch_s):.1f}% of the first epoch ("
          + ("under three steps" if warm_busy is None else f"{100 * warm_busy:.1f}%")
          + f" of its warm steps with their data waits), peak {peak:.2f} GiB, run "
          f"wall {wall:.1f} s, K1-K8 launches {sum(launches.values())}", flush=True)
    return trainer, (launches, shapes)


def _dg_cfg(root, tag, device, extra=()):
    from ovmr_tpu_torch import train as entry

    name, yaml, opts = DG_RUNS[tag]
    argv = dg_argv(root, root / f"{tag}-{device}", name, yaml,
                   [*opts, "CUDA.DEVICE", device, *extra])
    return entry.setup_cfg(entry.build_parser().parse_args(argv))


def _dg_trainer(torch, root, tag, device, extra=()):
    from ovmr_tpu_torch.engine.trainer import build_trainer
    from ovmr_tpu_torch.utils.tools import set_random_seed

    cfg = _dg_cfg(root, tag, device, extra)
    set_random_seed(cfg.SEED)  # as the entry point seeds before it builds
    return build_trainer(cfg)


# The card-vs-CPU gates. Two steps of each recipe from one seeded state on
# the same two batches: every loss each step returns within DG_LOSS_RTOL
# relative, every parameter and BN statistic within DG_LEAF_SHARE of its
# scale (:func:`_dg_scale`). DDAIG's adversarial G and DAELDG's experts are
# held at their JAX trajectory tests' tolerances
# (tests/test_trajectory_parity.py: losses rtol 2e-4 / 5e-4 with atol 2e-5,
# leaves atol 1e-4 + rtol 1e-3 element by element). Two local data shards
# (run (e)) are held against the card's one program at the plain gates.
# Controls, which must each fail a gate: the card's steps with cuDNN's TF32
# on and with every gradient DG_GRAD_FACTOR times its value (every trainer),
# and per-shard BatchNorm on the two shards (Vanilla).
# With GATE_DRIFT each line also prints the card's drift from itself under a
# 1e-6 change of the inputs, the JAX goldens' self-sensitivity reading. The
# steps run at
# DG_GATE_LR times the recipe's learning rate, the JAX goldens' way of
# keeping that drift well inside the gates: at the recipes' rates it reaches
# 2.7x a gate (DAELDG's losses, DDAIG's leaves), at a tenth 0.12x
# (tools/probe_torch_dassl_gates.py --phase dg; PERF.md).
DG_GATE_LR = 0.1  # times the recipe's learning rate
DG_LOSS_RTOL, DG_LEAF_SHARE = 1e-5, 1e-4
DG_CHAOTIC = {  # loss key -> (rtol, atol); leaves (atol, rtol) element by element
    "ddaig": ({"": (2e-4, 2e-5)}, (1e-4, 1e-3)),
    "daeldg": ({"": (2e-4, 2e-5), "loss_cr": (5e-4, 2e-5)}, (1e-4, 1e-3)),
}
DG_PERTURB = 1e-6
# the drift beside every gate of phases 20-22 (never asserted; read when a
# gate's lr cut is chosen): tools/probe_torch_dassl_gates.py turns it on,
# the smoke leaves it off (its ~20 replays cost the script's wall)
GATE_DRIFT = False
# the gradient control: a 20% error in each update (the plain gates catch
# 1%, DDAIG's JAX tolerances 5%; DAELDG's miss 5%: PERF.md)
DG_GRAD_FACTOR = 1.2


def _dg_replay(np, trainer, init, batches, tag, scale=None):
    """Two steps of ``trainer`` from ``init`` on ``batches`` (their images
    times ``1 + scale`` when given): each step's losses, walls, the states
    after."""
    from ovmr_tpu_torch.convert import dassl_state_from_numpy

    if scale is not None:
        batches = [{**b, **{k: (np.asarray(b[k], np.float32) * np.float32(1 + scale))
                            for k in ("img", "img2") if k in b}} for b in batches]
    for name, state in init.items():
        dassl_state_from_numpy(trainer._nets[name], state)
    # the first epoch (DDAIG's is past its warmup: both branches of its F step)
    trainer.epoch = 0
    trainer.before_epoch()
    losses, walls = [], []
    for b in batches:
        t = time.perf_counter()
        out = trainer.forward_backward(b)  # the loss read synchronises
        walls.append(time.perf_counter() - t)
        losses.append({k: v for k, v in out.items() if k.startswith("loss_") or k == "loss"})
    return losses, walls, {n: trainer.model_state(n) for n in trainer.get_model_names()}


def _dg_flat(state: dict, prefix=""):
    for k, v in state.items():
        if isinstance(v, dict):
            yield from _dg_flat(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


_DG_WEIGHT_OF = {"bias": ("scale", "kernel"), "mean": ("var",)}


def _dg_scale(np, leaf, want, start):
    """A leaf's scale: its max |value|. A bias or a BN running mean takes
    the larger of that and its module's weight's at the start (the BN scale
    or the kernel beside a bias, the running variance beside a mean), since
    its error adds to an output that weight scales: from a random start it
    starts at zero, and its two updates alone are no scale (the card drifts
    from itself by 5% of a BN bias's under a 1e-6 input change); from a
    trained start a bias before a BatchNorm holds only ~1e-10 of noise, as
    its gradient is zero but for rounding."""
    def reference(name):
        # a BatchNorm scale weighs its unit-variance output: its init, 1, is
        # its scale where it starts below it (the DA gates' zero-residual
        # start, DA_GATE_ZERO_RESIDUAL)
        ref = float(np.abs(start[name]).max())
        return max(ref, 1.0) if name.endswith("/scale") else ref

    scale = float(np.abs(want).max())
    head, _, last = leaf.rpartition("/")
    if last == "scale":
        return max(scale, reference(leaf))
    for weight in _DG_WEIGHT_OF.get(last, ()):
        if f"{head}/{weight}" in start:
            return max(scale, reference(f"{head}/{weight}"))
    return scale


def _dg_compare(np, run, ref, init, tag, chaotic=True):
    """``run``'s losses and leaves against ``ref``'s at ``tag``'s gates:
    (worst loss over its gate, worst leaf over its gate, that leaf's name,
    its error, its scale, the largest error over a leaf's update size).
    A ratio above 1 fails."""
    loss_gates, leaf_gate = {**DG_CHAOTIC, **DA_CHAOTIC}.get(tag, ({"": (DG_LOSS_RTOL, 0.0)}, None))
    if not chaotic:
        loss_gates, leaf_gate = {"": (DG_LOSS_RTOL, 0.0)}, None
    loss_ratio = 0.0
    for got, want in zip(run[0], ref[0]):
        for key, value in want.items():
            rtol, atol = loss_gates.get(key, loss_gates.get("", (DG_LOSS_RTOL, 0.0)))
            diff, gate = abs(got[key] - value), atol + rtol * abs(value)
            # a loss that is exactly zero (SE's masked consistency) holds only zero
            loss_ratio = max(loss_ratio, diff / gate if gate > 0 else (0.0 if diff == 0
                                                                        else math.inf))
    leaf_ratio, top, upd = 0.0, ("", 0.0, 0.0), 0.0
    for name in ref[2]:
        # a teacher starts as a copy of the student, "model"
        start = dict(_dg_flat(init[name if name in init else "model"]))
        got = dict(_dg_flat(run[2][name]))
        for leaf, want in _dg_flat(ref[2][name]):
            diff = np.abs(got[leaf] - want)
            err, scale = float(diff.max()), _dg_scale(np, leaf, want, start)
            if leaf_gate is None:
                ratio = err / (DG_LEAF_SHARE * scale) if scale > 0 else (0.0 if err == 0 else math.inf)
            else:
                atol, rtol = leaf_gate
                ratio = float((diff / (atol + rtol * np.abs(want))).max())
            if ratio >= leaf_ratio:
                leaf_ratio, top = ratio, (f"{name}/{leaf}", err, scale)
            step = float(np.abs(want - start[leaf]).max())
            if step > 0:
                upd = max(upd, err / step)
    return loss_ratio, leaf_ratio, top, upd


@contextlib.contextmanager
def _tf32_steps(torch):
    """Control: the Dassl steps with cuDNN's TF32 on (their fp32 scope,
    ``exact_fp32_convolutions``, replaced for the block)."""
    from ovmr_tpu_torch.engine import dassl_base, dg

    cudnn = torch.backends.cudnn

    @contextlib.contextmanager
    def tf32(dtype=None):
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=True):
            yield

    saved = dassl_base.exact_fp32_convolutions, dg.exact_fp32_convolutions
    dassl_base.exact_fp32_convolutions = dg.exact_fp32_convolutions = tf32
    try:
        yield
    finally:
        dassl_base.exact_fp32_convolutions, dg.exact_fp32_convolutions = saved


@contextlib.contextmanager
def _per_shard_batch_norm(torch):
    """Control: each local data shard's BatchNorm on its own rows' statistics
    (the first shard's running statistics kept), in place of the global
    batch's."""
    import torch.nn.functional as F

    from ovmr_tpu_torch.modeling.layers import TorchBatchNorm

    def per_shard(self, x, axis):
        return torch.cat([F.batch_norm(b, self.running_mean if i == 0 else None,
                                       self.running_var if i == 0 else None, self.weight,
                                       self.bias, True, self.momentum, self.eps)
                          for i, b in enumerate(axis.split(x))])

    saved = TorchBatchNorm._global_batch_norm
    TorchBatchNorm._global_batch_norm = per_shard
    try:
        yield
    finally:
        TorchBatchNorm._global_batch_norm = saved


@contextlib.contextmanager
def _scaled_gradients(torch, factor):
    """Control: every gradient ``factor`` times its value when the recipes'
    optimizer (sgd) steps."""
    from ovmr_tpu_torch.engine import optimizers

    orig = optimizers.SGD.step

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    p.grad.mul_(factor)
        return orig(self, closure)

    optimizers.SGD.step = step
    try:
        yield
    finally:
        optimizers.SGD.step = orig


def _dg_line(key, res):
    loss_ratio, leaf_ratio, (leaf, err, scale), upd = res
    return (f"{key}: loss {loss_ratio:.3g} of its gate, worst leaf {leaf} off by {err:.3g} "
            f"(scale {scale:.3g}) = {leaf_ratio:.3g} of its gate, worst leaf error "
            f"{upd:.3g} of its update")


def _noise_line(noise):
    """The drift's part of a gate line (none without GATE_DRIFT)."""
    return "" if noise is None else "; " + _dg_line(
        "noise (the card under a 1e-6 input change)", noise)


def _dg_gate_opts(root, tag):
    """The options of ``tag``'s gate steps: its recipe at DG_GATE_LR."""
    return ["OPTIM.LR", repr(_dg_cfg(root, tag, "cuda").OPTIM.LR * DG_GATE_LR)]


def dg_card_vs_cpu(torch, np, root: Path, tag: str):
    """The run's recipe, at the gates' learning rate, on the card and on
    the CPU from one seeded initial state (the card's, carried to the CPU
    trainer) and the same first two batches (pulled once), held by the gates
    above; the TF32 and 20%-gradient controls fail them; for Vanilla, the
    same two steps on
    two local data shards against the card's one program, and the
    per-shard BatchNorm control, which fails them."""
    lr = _dg_gate_opts(root, tag)
    card = _dg_trainer(torch, root, tag, "cuda", lr)
    init = {name: card.model_state(name) for name in card.get_model_names()}
    stream = iter(card.train_loader)
    batches = [next(stream), next(stream)]
    stream.close()
    on_card = _dg_replay(np, card, init, batches, tag)
    t = time.perf_counter()
    on_cpu = _dg_replay(np, _dg_trainer(torch, root, tag, "cpu", lr), init, batches, tag)
    cpu_s = time.perf_counter() - t
    noise = _dg_compare(np, _dg_replay(np, _dg_trainer(torch, root, tag, "cuda", lr), init,
                                       batches, tag, scale=DG_PERTURB), on_card, init,
                        tag) if GATE_DRIFT else None
    with _tf32_steps(torch):
        tf32 = _dg_compare(np, _dg_replay(np, _dg_trainer(torch, root, tag, "cuda", lr), init,
                                          batches, tag), on_cpu, init, tag)
    with _scaled_gradients(torch, DG_GRAD_FACTOR):
        scaled = _dg_compare(np, _dg_replay(np, _dg_trainer(torch, root, tag, "cuda", lr), init,
                                            batches, tag), on_cpu, init, tag)
    held = {"card vs cpu": _dg_compare(np, on_card, on_cpu, init, tag)}
    controls = {"tf32 on vs cpu": tf32, f"gradients x {DG_GRAD_FACTOR} vs cpu": scaled}
    if tag == "vanilla":
        shards = ["CUDA.MESH.DATA", "2", *lr]
        held["2 local data shards vs one program"] = _dg_compare(
            np, _dg_replay(np, _dg_trainer(torch, root, tag, "cuda", shards), init, batches, tag),
            on_card, init, tag, chaotic=False)
        with _per_shard_batch_norm(torch):
            controls["per-shard BN vs one program"] = _dg_compare(
                np, _dg_replay(np, _dg_trainer(torch, root, tag, "cuda", shards), init, batches,
                               tag), on_card, init, tag, chaotic=False)
    print(f"[dg] {tag} gates (fp32, TF32 off in the steps, 2 steps at lr {lr[1]}; card losses "
          f"{[round(v['loss'], 6) for v in on_card[0]]}; the card's warm step "
          f"{1e3 * on_card[1][1]:.1f} ms, unprofiled; the CPU's two {cpu_s:.1f} s): "
          + "; ".join(_dg_line(k, r) for k, r in held.items())
          + "; controls: " + "; ".join(_dg_line(k, r) for k, r in controls.items())
          + _noise_line(noise), flush=True)
    for key, (loss_ratio, leaf_ratio, (leaf, err, scale), _) in held.items():
        if loss_ratio > 1 or leaf_ratio > 1:
            raise AssertionError(f"[dg] {tag} {key}: losses at {loss_ratio:.3g} of their gate, "
                                 f"{leaf} off by {err:.3g} (scale {scale:.3g}) at "
                                 f"{leaf_ratio:.3g} of its gate")
    for key, (loss_ratio, leaf_ratio, _, _) in controls.items():
        if loss_ratio <= 1 and leaf_ratio <= 1:
            raise AssertionError(f"[dg] {tag} control {key} met every gate: the gates cannot "
                                 f"tell it from the path")


def dg_phase(torch, np, root: Path):
    """Phase 20: a PACS-layout tree under ``root``, then the published
    recipes on the card through the entry point (Vanilla, DDAIG, DAELDG,
    CrossGrad, DomainMix, Vanilla on 2 local data shards) and each one's
    card-vs-CPU gate."""
    t0 = time.perf_counter()
    # torch's own TF32 defaults, as a user's process has them, for the whole
    # phase: the entry point and the Dassl steps must turn TF32 off themselves
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True
    try:
        n = write_pacs(np, root)
        print(f"[dg] PACS tree: {n} images ({len(PACS_DOMAINS)} domains x {len(PACS_CLASSES)} "
              f"classes x {PACS_TRAIN + PACS_VAL}) in {time.perf_counter() - t0:.1f} s; sources "
              f"{list(DG_SOURCES)}, target {DG_TARGET}", flush=True)
        # the gates first: their card steps also warm cuDNN's plans and
        # lazily loaded kernels for the timed runs after them
        t = time.perf_counter()
        for tag in ("vanilla", "ddaig", "daeldg", "crossgrad", "domainmix"):
            dg_card_vs_cpu(torch, np, root, tag)
            torch.cuda.empty_cache()
        print(f"[dg] the gates in {time.perf_counter() - t:.1f} s", flush=True)
        paths = {}
        for tag in DG_RUNS:
            _, paths[f"dg_{tag}"] = dg_run(torch, np, root, tag)
            torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    print(f"[dg] phase 20 in {time.perf_counter() - t0:.1f} s", flush=True)
    return paths


# ---------------------------------------------------------------------------
# phase 21: the Dassl DA trainers at Office-31's and Digit-5's recipes
# ---------------------------------------------------------------------------

OFFICE31_DOMAINS = ("amazon", "webcam", "dslr")
OFFICE31_SHOTS = 5  # JPEGs a class a domain
DIGIT5_DOMAINS = ("mnist", "mnist_m", "svhn", "syn", "usps")
DIGIT5_TRAIN, DIGIT5_TEST = 20, 4  # PNGs a class a domain
DA_SEED = 1
# two of the published tasks: Office-31 A -> W, Digit-5 -> USPS (whose train
# set the loader repeats 3x, here the target pool)
OFFICE31_SOURCES, OFFICE31_TARGET = ("amazon",), "webcam"
DIGIT5_SOURCES, DIGIT5_TARGET = ("mnist", "mnist_m", "svhn", "syn"), "usps"


def write_da_trees(np, root: Path) -> int:
    """An Office-31 tree (``office31/<domain>/<class>/*.jpg``, 31 classes at
    256 x 256) and a Digit-5 tree (``digit5/<domain>/{train,test}_images/
    <i>_<label>.png``, 10 classes at 32 x 32), drawn from :data:`DA_SEED`:
    each class a colour and a stripe frequency, each domain a contrast, plus
    noise. Returns the number of images."""
    import concurrent.futures as cf

    from PIL import Image

    def save(pixels, path):
        Image.fromarray(pixels).save(path, quality=90) if path.suffix == ".jpg" else \
            Image.fromarray(pixels).save(path)

    def image(rng, side, c, d, grid):
        yy, xx = grid
        hue = np.array([(c * 37) % 255, (c * 91) % 255, (c * 53) % 255]) / 255.0
        stripes = np.sin((xx * (c % 7 + 2) + yy * (d + 1 + c // 7)) * 2 * np.pi)[..., None]
        img = 0.5 + (0.15 + 0.1 * d) * stripes * hue + rng.normal(0, 0.08, (side, side, 3))
        return (np.clip(img, 0, 1) * 255).astype(np.uint8)

    rng = np.random.default_rng(DA_SEED)
    jobs = []
    with cf.ThreadPoolExecutor(max_workers=8) as pool:  # the draws stay in order
        grid = np.mgrid[0:256, 0:256] / 256.0
        for d, domain in enumerate(OFFICE31_DOMAINS):
            for c in range(31):
                cdir = root / "office31" / domain / f"class_{c:02d}"
                cdir.mkdir(parents=True, exist_ok=True)
                for i in range(OFFICE31_SHOTS):
                    jobs.append(pool.submit(save, image(rng, 256, c, d, grid), cdir / f"{i}.jpg"))
        grid = np.mgrid[0:32, 0:32] / 32.0
        for d, domain in enumerate(DIGIT5_DOMAINS):
            for split, n in (("train_images", DIGIT5_TRAIN), ("test_images", DIGIT5_TEST)):
                sdir = root / "digit5" / domain / split
                sdir.mkdir(parents=True, exist_ok=True)
                for c in range(10):
                    for i in range(n):
                        jobs.append(pool.submit(save, image(rng, 32, c, d, grid),
                                                sdir / f"{c * n + i}_{c}.png"))
        for job in jobs:
            job.result()
    return len(jobs)


# run -> (trainer, dataset, the trainer's yaml, the cuts and the trainer's
# own required settings as options). SE needs two views of an image
# (K_TRANSFORMS 2), which Digit-5's SourceOnly yaml does not set. CDAC's
# epoch counts its unlabelled stream's 3 steps, not the labelled one's 12,
# to keep the script inside its time limit (its gate steps on its own).
DA_RUNS = {
    "source_only": ("SourceOnly", "office31", "source_only", ["OPTIM.MAX_EPOCH", "1"]),
    "adda": ("ADDA", "office31", "source_only", ["OPTIM.MAX_EPOCH", "1"]),
    "adabn": ("AdaBN", "office31", "source_only", ["OPTIM.MAX_EPOCH", "1"]),
    "dann": ("DANN", "office31", "source_only", ["OPTIM.MAX_EPOCH", "1"]),
    "dann_data2": ("DANN", "office31", "source_only",
                   ["OPTIM.MAX_EPOCH", "1", "CUDA.MESH.DATA", "2"]),
    "mcd": ("MCD", "digit5", "source_only", ["OPTIM.MAX_EPOCH", "1"]),
    "mme": ("MME", "digit5", "source_only", ["OPTIM.MAX_EPOCH", "1"]),
    "se": ("SE", "digit5", "source_only", ["OPTIM.MAX_EPOCH", "1", "DATALOADER.K_TRANSFORMS", "2"]),
    "m3sda": ("M3SDA", "digit5", "m3sda", ["OPTIM.MAX_EPOCH", "1"]),
    "dael": ("DAEL", "digit5", "dael", ["OPTIM.MAX_EPOCH", "1"]),
    "cdac": ("CDAC", "digit5", "cdac", ["OPTIM.MAX_EPOCH", "1", "TRAIN.COUNT_ITER", "train_u"]),
}
# ADDA and AdaBN start from the checkpoint SourceOnly's run wrote
DA_FROM_SOURCE = ("adda", "adabn")


def da_argv(root: Path, out: Path, tag: str, opts=()):
    """``python -m ovmr_tpu_torch.train`` arguments of a DA run: the dataset
    yaml, the trainer's yaml, the sources and the target, and the run's cuts
    as options (ADDA and AdaBN also ``MODEL.INIT_WEIGHTS``: SourceOnly's
    checkpoint under ``root``)."""
    name, dataset, yaml, cuts = DA_RUNS[tag]
    sources, target = ((OFFICE31_SOURCES, OFFICE31_TARGET) if dataset == "office31"
                       else (DIGIT5_SOURCES, DIGIT5_TARGET))
    cfg_dir = ROOT / "configs"
    extra = []
    if tag in DA_FROM_SOURCE:
        extra = ["MODEL.INIT_WEIGHTS", str(root / "source_only" / "model" / "model-1.npz")]
    return ["--root", str(root), "--seed", str(DA_SEED), "--trainer", name,
            "--dataset-config-file", str(cfg_dir / "datasets" / "da" / f"{dataset}.yaml"),
            "--config-file", str(cfg_dir / "trainers" / "da" / yaml / f"{dataset}.yaml"),
            "--output-dir", str(out),
            "DATASET.SOURCE_DOMAINS", repr(list(sources)),
            "DATASET.TARGET_DOMAINS", repr([target]),
            "DATALOADER.NUM_WORKERS", "8", *cuts, *extra, *opts]


def da_run(torch, np, root: Path, tag: str):
    """One DA run through ``ovmr_tpu_torch.train.main`` on the card
    (:func:`dassl_entry_run`)."""
    from ovmr_tpu_torch.engine import da

    classes = {getattr(da, n) for n in ("SourceOnly", "DANN", "ADDA", "AdaBN", "MCD", "MME", "SE",
                                        "M3SDA", "DAEL", "CDAC")}
    wraps = [(cls, "forward_backward_xu") for cls in sorted(classes, key=lambda c: c.__name__)]
    return dassl_entry_run(torch, "da", tag, root / tag, wraps, da_argv(root, root / tag, tag))


# The gates: phase 20's (DG_LOSS_RTOL, DG_LEAF_SHARE, DG_GATE_LR times the
# recipe's learning rate, DG_PERTURB), each trainer's losses read from the
# keys that name a loss. M3SDA, DAEL and CDAC are held at their JAX
# trajectory tests' tolerances (tests/test_trajectory_parity.py:1263-1275,
# 1391-1407, 1525-1544: losses (rtol, atol), leaves (atol, rtol) element by
# element): their losses span the whole batch and their trajectories hang
# on max-pool near-ties (tests/test_torch_da_trajectory.py). The
# ResNet-50 recipes step a batch of DA_GATE_BATCH, so the CPU replay stays
# short.
DA_CHAOTIC = {
    "m3sda": ({"": (2e-4, 2e-5), "loss_step_C": (5e-4, 2e-5)}, (1e-4, 1e-3)),
    "dael": ({"": (2e-4, 2e-5), "loss_cr": (5e-4, 2e-5), "loss_u": (5e-4, 2e-5)}, (1e-4, 1e-3)),
    "cdac": ({"": (5e-4, 5e-5), "pl_loss": (1e-3, 5e-5), "cons_loss": (1e-3, 5e-5)},
             (2e-4, 1e-3)),
}
DA_GATE_BATCH = 8
# Each gate runs at a cut of its recipe's learning rate (1, 0.1, 0.01 or
# 0.001) at which the card's own drift under a 1e-6 input change and the card
# against the CPU stay well inside its gates while both controls fail them,
# whichever batches the trees' folder order gives (the loaders keep a
# folder's listing unsorted, as the reference does, so each filesystem
# draws others): phase 20's tenth (DG_GATE_LR) for ADDA and AdaBN; at a
# tenth SourceOnly reads card vs CPU up to 1.45 of its gates on one
# machine's order and 0.999 on one of eight shuffled ones (0.11 at 0.01,
# where its controls read >= 1.53), DANN up to 1.31 and its two local
# shards, DAEL, MME and SE 0.4-2.5, and MCD and M3SDA (their phases step F
# up to ten times) 1-23; CDAC's recipe is at 1e-3, where a tenth leaves its
# gradient control at 1.2-2.1 of its gates
# (tools/probe_torch_dassl_gates.py --phase da [--orders N]; PERF.md).
DA_GATE_LR_CUT = {"source_only": 0.01, "dann": 0.01, "dael": 0.01, "mme": 0.01, "se": 0.01,
                  "mcd": 0.001, "m3sda": 0.001, "cdac": 1.0}
# The ResNet-50 recipes' gates start with every bottleneck's last BatchNorm
# scale at zero (torchvision's ``zero_init_residual``), as the card and the
# CPU can agree on two steps of a well-conditioned network only: from the
# random init a 1e-6 change of the input moves the card's second step by
# thousands of times the gates (tools/probe_torch_dassl_gates.py --phase da
# --random-start; PERF.md).
DA_GATE_ZERO_RESIDUAL = True


def _zero_residual(init: dict) -> dict:
    """``init`` with the last BatchNorm scale of each residual branch
    (``bn3``) at zero."""
    def walk(tree, path=()):
        return {k: walk(v, path + (k,)) if isinstance(v, dict) else
                (v * 0 if path[-1:] == ("bn3",) and k == "scale" else v)
                for k, v in tree.items()}

    return {name: walk(state) for name, state in init.items()}


@contextlib.contextmanager
def _host_draws(torch):
    """Every trainer's step draws (dropout masks) from a CPU generator seeded
    as its own would be, so the card's replays and the CPU's draw the same
    masks; a trainer on the card draws from a generator on the card."""
    from ovmr_tpu_torch.engine import dassl_base

    orig = dassl_base.DasslTrainer.step_generator

    def step_generator(self):
        return torch.Generator().manual_seed(orig(self).initial_seed())

    dassl_base.DasslTrainer.step_generator = step_generator
    try:
        yield
    finally:
        dassl_base.DasslTrainer.step_generator = orig


def _two_batches(loader):
    """A loader's first two batches, restarting it where it runs out first,
    as :class:`TrainerXU`'s epoch does."""
    out, stream = [], iter(loader)
    while len(out) < 2:
        try:
            out.append(next(stream))
        except StopIteration:
            stream = iter(loader)
    return out


def _da_cfg(root, tag, device, extra=()):
    from ovmr_tpu_torch import train as entry

    argv = da_argv(root, root / f"{tag}-{device}", tag, ["CUDA.DEVICE", device, *extra])
    return entry.setup_cfg(entry.build_parser().parse_args(argv))


def _da_trainer(torch, root, tag, device, extra=()):
    from ovmr_tpu_torch.engine.trainer import build_trainer
    from ovmr_tpu_torch.utils.tools import set_random_seed

    cfg = _da_cfg(root, tag, device, extra)
    set_random_seed(cfg.SEED)  # as the entry point seeds before it builds
    return build_trainer(cfg)


def _da_replay(torch, np, trainer, init, batches, tag, scale=None):
    """Two steps of ``trainer`` from ``init`` on ``batches`` (pairs of the
    labelled and unlabelled batches; their images times ``1 + scale`` when
    given), as the first two of an epoch of two: each step's losses, walls,
    the states after."""
    from ovmr_tpu_torch.convert import dassl_state_from_numpy, dassl_state_to_numpy

    def scaled(b):
        return {**b, **{k: (np.asarray(b[k], np.float32) * np.float32(1 + scale))
                        for k in ("img", "img2") if k in b}}

    if scale is not None:
        batches = [(scaled(bx), scaled(bu)) for bx, bu in batches]
    for name, state in init.items():
        dassl_state_from_numpy(trainer._nets[name], state)
    if hasattr(trainer, "copy_teacher"):  # SE's and MeanTeacher's: a copy of the student
        trainer.copy_teacher()
    trainer.epoch, trainer.max_epoch, trainer.num_batches = 0, 1, len(batches)
    trainer.before_epoch()
    losses, walls = [], []
    for trainer.batch_idx, (bx, bu) in enumerate(batches):
        t = time.perf_counter()
        out = trainer.forward_backward_xu(bx, bu) or {}
        if trainer.device.type == "cuda":  # AdaBN returns no loss to read
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        # FixMatch's mask share too: a flipped pseudo-label shows there
        losses.append({k: v for k, v in out.items() if "loss" in k or k == "y_u_pred_keep"})
    states = {n: trainer.model_state(n) for n in trainer.get_model_names()}
    if hasattr(trainer, "teacher"):  # SE's and MeanTeacher's: EMA'd, its own BN statistics
        states["teacher"] = dassl_state_to_numpy(trainer.teacher)
    return losses, walls, states


@contextlib.contextmanager
def _no_statistics_reset(torch):
    """Control (AdaBN, which takes no gradient): the source model's BN
    statistics are not reset before they are re-estimated."""
    from ovmr_tpu_torch.engine import da, dassl_base

    saved = da.AdaBN.before_epoch
    da.AdaBN.before_epoch = dassl_base.DasslTrainer.before_epoch
    try:
        yield
    finally:
        da.AdaBN.before_epoch = saved


def da_card_vs_cpu(torch, np, root: Path, tag: str):
    """The run's recipe, at the gates' learning rate, on the card and on the
    CPU from one seeded initial state (the card's, carried to the CPU
    trainer), the same first two pairs of batches (pulled once) and the same
    dropout masks (:func:`_host_draws`), held by the gates above; the TF32
    and gradient (AdaBN: statistics-reset) controls fail them; for DANN, the
    same two steps on two local data shards against the card's one program,
    and the per-shard BatchNorm control, which fails them."""
    with _host_draws(torch):
        _da_card_vs_cpu(torch, np, root, tag)


def _da_gate_opts(root, tag):
    """The options of ``tag``'s gate steps: its recipe at its cut of the
    learning rate, the ResNet-50 recipes at DA_GATE_BATCH."""
    cut = DA_GATE_LR_CUT.get(tag, DG_GATE_LR)
    lr = ["OPTIM.LR", repr(_da_cfg(root, tag, "cuda").OPTIM.LR * cut)]
    if DA_RUNS[tag][1] == "office31":
        lr += ["DATALOADER.TRAIN_X.BATCH_SIZE", str(DA_GATE_BATCH)]
    return lr


def _da_card_vs_cpu(torch, np, root: Path, tag: str):
    lr = _da_gate_opts(root, tag)
    card = _da_trainer(torch, root, tag, "cuda", lr)
    init = {n: card.model_state(n) for n in card.get_model_names()}
    if DA_RUNS[tag][1] == "office31" and DA_GATE_ZERO_RESIDUAL:
        init = _zero_residual(init)
    batches = list(zip(_two_batches(card.dm.train_loader_x),
                       _two_batches(card.dm.train_loader_u)))

    def replay(device="cuda", extra=lr, scale=None):
        trainer = _da_trainer(torch, root, tag, device, extra)
        return _da_replay(torch, np, trainer, init, batches, tag, scale=scale)

    on_card = _da_replay(torch, np, card, init, batches, tag)
    t = time.perf_counter()
    on_cpu = replay("cpu")
    cpu_s = time.perf_counter() - t
    noise = (_dg_compare(np, replay(scale=DG_PERTURB), on_card, init, tag)
             if GATE_DRIFT else None)
    with _tf32_steps(torch):
        tf32 = _dg_compare(np, replay(), on_cpu, init, tag)
    if tag == "adabn":
        second, control = _no_statistics_reset(torch), "no statistics reset vs cpu"
    else:
        second, control = (_scaled_gradients(torch, DG_GRAD_FACTOR),
                           f"gradients x {DG_GRAD_FACTOR} vs cpu")
    with second:
        other = _dg_compare(np, replay(), on_cpu, init, tag)
    held = {"card vs cpu": _dg_compare(np, on_card, on_cpu, init, tag)}
    controls = {"tf32 on vs cpu": tf32, control: other}
    if tag == "dann":
        shards = ["CUDA.MESH.DATA", "2", *lr]
        held["2 local data shards vs one program"] = _dg_compare(
            np, replay(extra=shards), on_card, init, tag, chaotic=False)
        with _per_shard_batch_norm(torch):
            controls["per-shard BN vs one program"] = _dg_compare(
                np, replay(extra=shards), on_card, init, tag, chaotic=False)
    _hold_gates("da", tag, lr[1], batches, on_card, cpu_s, held, controls, noise)


def _hold_gates(prefix, tag, lr, batches, on_card, cpu_s, held, controls, noise):
    """Print an XU trainer's gate readings; raise where the path misses a
    gate or a control meets every gate."""
    first = on_card[0][0]
    print(f"[{prefix}] {tag} gates (fp32, TF32 off in the steps, 2 steps at lr {lr}, batch "
          f"{len(batches[0][0]['label'])} + {len(batches[0][1]['label'])}; card losses "
          f"{ {k: round(v, 6) for k, v in first.items()} }; the card's warm step "
          f"{1e3 * on_card[1][1]:.1f} ms, unprofiled; the CPU's two {cpu_s:.1f} s): "
          + "; ".join(_dg_line(k, r) for k, r in held.items())
          + "; controls: " + "; ".join(_dg_line(k, r) for k, r in controls.items())
          + _noise_line(noise), flush=True)
    for key, (loss_ratio, leaf_ratio, (leaf, err, scale), _) in held.items():
        if loss_ratio > 1 or leaf_ratio > 1:
            raise AssertionError(f"[{prefix}] {tag} {key}: losses at {loss_ratio:.3g} of their "
                                 f"gate, {leaf} off by {err:.3g} (scale {scale:.3g}) at "
                                 f"{leaf_ratio:.3g} of its gate")
    for key, (loss_ratio, leaf_ratio, _, _) in controls.items():
        if loss_ratio <= 1 and leaf_ratio <= 1:
            raise AssertionError(f"[{prefix}] {tag} control {key} met every gate: the gates "
                                 f"cannot tell it from the path")


def da_phase(torch, np, root: Path):
    """Phase 21: an Office-31 and a Digit-5 tree under ``root``, each
    trainer's card-vs-CPU gate, then the eleven runs through the entry
    point. SourceOnly runs first, since the gates and runs of ADDA and AdaBN
    start from its checkpoint."""
    t0 = time.perf_counter()
    # torch's own TF32 defaults, as a user's process has them, for the whole
    # phase: the entry point and the Dassl steps must turn TF32 off themselves
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True
    try:
        n = write_da_trees(np, root)
        print(f"[da] Office-31 and Digit-5 trees: {n} images in {time.perf_counter() - t0:.1f} s; "
              f"Office-31 {list(OFFICE31_SOURCES)} -> {OFFICE31_TARGET}, Digit-5 "
              f"{list(DIGIT5_SOURCES)} -> {DIGIT5_TARGET}", flush=True)
        paths = {}
        _, paths["da_source_only"] = da_run(torch, np, root, "source_only")
        torch.cuda.empty_cache()
        t = time.perf_counter()
        for tag in ("source_only", "adda", "adabn", "dann", "mcd", "mme", "se", "m3sda", "dael",
                    "cdac"):
            da_card_vs_cpu(torch, np, root, tag)
            torch.cuda.empty_cache()
        print(f"[da] the gates in {time.perf_counter() - t:.1f} s", flush=True)
        for tag in DA_RUNS:
            if tag != "source_only":
                _, paths[f"da_{tag}"] = da_run(torch, np, root, tag)
                torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    print(f"[da] phase 21 in {time.perf_counter() - t0:.1f} s", flush=True)
    return paths


# ---------------------------------------------------------------------------
# phase 22: the Dassl SSL trainers at CIFAR-10's FixMatch recipe, and lpclip
# ---------------------------------------------------------------------------

CIFAR10_CLASSES = ("airplane", "automobile", "bird", "cat", "deer", "dog", "frog", "horse",
                   "ship", "truck")
CIFAR10_TRAIN, CIFAR10_TEST = 400, 20  # PNGs a class
SSL_SEED = 1
# the recipe's 4000 labels cut to FixMatch's own smallest CIFAR-10 setting;
# an epoch counts the labelled stream's 3 steps, not the unlabelled one's 8,
# to keep the script inside its time limit (the gates step on their own)
SSL_CUTS = ["OPTIM.MAX_EPOCH", "1", "DATASET.NUM_LABELED", "250", "TRAIN.COUNT_ITER", "train_x"]
# run -> (trainer, its own settings as options): every trainer runs on
# FixMatch's CIFAR-10 yamls with its name changed; MixMatch needs two views
SSL_RUNS = {
    "fixmatch": ("FixMatch", []),
    "fixmatch_data2": ("FixMatch", ["CUDA.MESH.DATA", "2"]),
    "sup_baseline": ("SupBaseline", []),
    "entmin": ("EntMin", []),
    "mean_teacher": ("MeanTeacher", []),
    "mixmatch": ("MixMatch", ["DATALOADER.K_TRANSFORMS", "2"]),
}


def write_cifar10(np, root: Path) -> int:
    """A CIFAR-10-layout tree (``cifar10/{train,test}/<class>/*.png`` at 32 x
    32), drawn from :data:`SSL_SEED`: each class a colour and a stripe
    frequency, plus noise. Returns the number of images."""
    import concurrent.futures as cf

    from PIL import Image

    def save(pixels, path):
        Image.fromarray(pixels).save(path)

    rng = np.random.default_rng(SSL_SEED)
    yy, xx = np.mgrid[0:32, 0:32] / 32.0
    jobs = []
    with cf.ThreadPoolExecutor(max_workers=8) as pool:  # the draws stay in order
        for split, n in (("train", CIFAR10_TRAIN), ("test", CIFAR10_TEST)):
            for c, cname in enumerate(CIFAR10_CLASSES):
                cdir = root / "cifar10" / split / cname
                cdir.mkdir(parents=True, exist_ok=True)
                hue = np.array([(c * 37) % 255, (c * 91) % 255, (c * 53) % 255]) / 255.0
                stripes = np.sin((xx * (c % 5 + 2) + yy * (c // 5 + 1)) * 2 * np.pi)[..., None]
                for i in range(n):
                    img = 0.5 + 0.3 * stripes * hue + rng.normal(0, 0.1, (32, 32, 3))
                    jobs.append(pool.submit(save, (np.clip(img, 0, 1) * 255).astype(np.uint8),
                                            cdir / f"{i:04d}.png"))
        for job in jobs:
            job.result()
    return len(jobs)


def ssl_argv(root: Path, out: Path, tag: str, opts=()):
    """``python -m ovmr_tpu_torch.train`` arguments of an SSL run: CIFAR-10's
    dataset yaml, FixMatch's CIFAR-10 yaml, the trainer, and the run's cuts
    and settings as options."""
    name, extra = SSL_RUNS[tag]
    cfg_dir = ROOT / "configs"
    return ["--root", str(root), "--seed", str(SSL_SEED), "--trainer", name,
            "--dataset-config-file", str(cfg_dir / "datasets" / "ssl" / "cifar10.yaml"),
            "--config-file", str(cfg_dir / "trainers" / "ssl" / "fixmatch" / "cifar10.yaml"),
            "--output-dir", str(out), "DATALOADER.NUM_WORKERS", "8", *SSL_CUTS, *extra, *opts]


def ssl_run(torch, np, root: Path, tag: str):
    """One SSL run through ``ovmr_tpu_torch.train.main`` on the card
    (:func:`dassl_entry_run`)."""
    from ovmr_tpu_torch.engine import ssl

    wraps = [(getattr(ssl, n), "forward_backward_xu")
             for n in ("SupBaseline", "EntMin", "MeanTeacher", "MixMatch", "FixMatch")]
    return dassl_entry_run(torch, "ssl", tag, root / tag, wraps, ssl_argv(root, root / tag, tag))


# The gates: phase 21's (DG_LOSS_RTOL, DG_LEAF_SHARE, DG_PERTURB; the same
# dropout masks on both sides), two steps of SSL_GATE_BATCH labelled +
# unlabelled images (a cut of the recipe's 64 + 448, which bounds the CPU
# replay) at SSL_GATE_LR times the recipe's lr, with SSL_GATE_OPTS.
# MeanTeacher's teacher is held with the student. FixMatch on two local data
# shards is held against the card's one program, and per-shard BatchNorm
# must fail it. One cut holds all five trainers, as the card's drift from
# itself under a 1e-6 input change and the card against the CPU stay at or
# below half of every gate there alone, on every card the probe ran on,
# while both controls fail every trainer: at a tenth they read 0.83-3.0 of
# the leaf gate card vs CPU, at 0.03 0.36-0.97 (SupBaseline, EntMin and
# MeanTeacher 0.41 on two cards, 0.93-0.97 on a third), at a hundredth
# 0.04-0.13 (tools/probe_torch_dassl_gates.py --phase ssl; PERF.md).
SSL_GATE_BATCH = (16, 64)
SSL_GATE_LR = 0.01
# FixMatch's confidence threshold in the gate: at 0.95 the random init keeps
# no pseudo-label (its softmax peaks at 0.13-0.18 on the gate's first batch,
# measured on the CPU), so the strong-view loss would be 0 on both sides;
# at 0.15 about half the rows pass
SSL_GATE_OPTS = {"fixmatch": ["TRAINER.FIXMATCH.CONF_THRE", "0.15"]}


def _ssl_cfg(root, tag, device, extra=()):
    from ovmr_tpu_torch import train as entry

    argv = ssl_argv(root, root / f"{tag}-{device}", tag, ["CUDA.DEVICE", device, *extra])
    return entry.setup_cfg(entry.build_parser().parse_args(argv))


def _ssl_trainer(torch, root, tag, device, extra=()):
    from ovmr_tpu_torch.engine.trainer import build_trainer
    from ovmr_tpu_torch.utils.tools import set_random_seed

    cfg = _ssl_cfg(root, tag, device, extra)
    set_random_seed(cfg.SEED)  # as the entry point seeds before it builds
    return build_trainer(cfg)


def _ssl_gate_opts(root, tag):
    """The options of ``tag``'s gate steps: its recipe at SSL_GATE_LR and
    SSL_GATE_BATCH, with SSL_GATE_OPTS."""
    return ["OPTIM.LR", repr(_ssl_cfg(root, tag, "cuda").OPTIM.LR * SSL_GATE_LR),
            "DATALOADER.TRAIN_X.BATCH_SIZE", str(SSL_GATE_BATCH[0]),
            "DATALOADER.TRAIN_U.BATCH_SIZE", str(SSL_GATE_BATCH[1]),
            *SSL_GATE_OPTS.get(tag, [])]


def ssl_card_vs_cpu(torch, np, root: Path, tag: str):
    """The run's recipe at the gates' lr and batch, on the card and on the
    CPU from one seeded initial state (the card's, carried to the CPU
    trainer), the same first two pairs of batches (pulled once) and the same
    dropout masks (:func:`_host_draws`; MixMatch's shuffle and mixup
    coefficients come from the step's seed on both), held by the gates
    above; the TF32 and 20%-gradient controls fail them; for FixMatch, the
    same two steps on two local data shards against the card's one program,
    and the per-shard BatchNorm control, which fails them."""
    with _host_draws(torch):
        opts = _ssl_gate_opts(root, tag)
        card = _ssl_trainer(torch, root, tag, "cuda", opts)
        init = {n: card.model_state(n) for n in card.get_model_names()}
        batches = list(zip(_two_batches(card.dm.train_loader_x),
                           _two_batches(card.dm.train_loader_u)))

        def replay(device="cuda", extra=opts, scale=None):
            trainer = _ssl_trainer(torch, root, tag, device, extra)
            return _da_replay(torch, np, trainer, init, batches, tag, scale=scale)

        on_card = _da_replay(torch, np, card, init, batches, tag)
        t = time.perf_counter()
        on_cpu = replay("cpu")
        cpu_s = time.perf_counter() - t
        noise = (_dg_compare(np, replay(scale=DG_PERTURB), on_card, init, tag)
                 if GATE_DRIFT else None)
        with _tf32_steps(torch):
            tf32 = _dg_compare(np, replay(), on_cpu, init, tag)
        with _scaled_gradients(torch, DG_GRAD_FACTOR):
            scaled = _dg_compare(np, replay(), on_cpu, init, tag)
        held = {"card vs cpu": _dg_compare(np, on_card, on_cpu, init, tag)}
        controls = {"tf32 on vs cpu": tf32, f"gradients x {DG_GRAD_FACTOR} vs cpu": scaled}
        if tag == "fixmatch":
            shards = ["CUDA.MESH.DATA", "2", *opts]
            held["2 local data shards vs one program"] = _dg_compare(
                np, replay(extra=shards), on_card, init, tag, chaotic=False)
            with _per_shard_batch_norm(torch):
                controls["per-shard BN vs one program"] = _dg_compare(
                    np, replay(extra=shards), on_card, init, tag, chaotic=False)
    _hold_gates("ssl", tag, opts[1], batches, on_card, cpu_s, held, controls, noise)


# lpclip on the card: a seeded random ViT-B/16 tower (no CLIP weights here)
# over Synthetic at 224 px, at the batch of the test pass phase 2 holds K1
# and K2 at (``vision-test-100``); the fp32 features card vs CPU on a small
# Synthetic set, held at 1e-4 of their scale (PERF.md §2 "features 1e-4")
LPCLIP_SYNTHETIC, LPCLIP_FP32_SYNTHETIC = "100,12,224", "4,4,224"
LPCLIP_BATCH = 100
LPCLIP_FP32_TOL = 1e-4


def lpclip_phase(torch, np, root: Path):
    """``python -m ovmr_tpu_torch.lpclip``'s ``main`` (its ``build`` and
    ``dump``) for the train and test splits in bf16 (images a second over the
    dump, K1/K2 launches with the counts zeroed just before each build, 12 +
    12 a batch, and no other kernel; raw finite features), then fp32 on the
    card against the CPU. Returns the bf16 runs' (launches, shapes)."""
    import os

    from ovmr_tpu_torch.data.datasets.synthetic import Synthetic
    from ovmr_tpu_torch.lpclip import feat_extractor as lp
    from ovmr_tpu_torch.ops import cuda_lib

    def args(split, out, *opts):
        return lp.build_parser().parse_args([
            "--root", str(root / "data"), "--split", split, "--output-dir", str(out),
            "--backbone", "ViT-B/16", "--seed", "1", "DATASET.NAME", "Synthetic",
            "DATALOADER.NUM_WORKERS", "8", *opts])

    saved = os.environ.get("OVMR_SYNTHETIC")
    os.environ["OVMR_SYNTHETIC"] = LPCLIP_SYNTHETIC
    try:
        t = time.perf_counter()
        Synthetic(lp.setup_cfg(args("train", root / "lp")))  # writes the PNGs
        print(f"[lpclip] Synthetic {LPCLIP_SYNTHETIC} written in {time.perf_counter() - t:.1f} s",
              flush=True)
        batch = ["DATALOADER.TRAIN_X.BATCH_SIZE", str(LPCLIP_BATCH),
                 "DATALOADER.TEST.BATCH_SIZE", str(LPCLIP_BATCH)]
        launches, shapes = None, {}
        for split in ("train", "test"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            cuda_lib.reset_launches()
            setup = lp.build(args(split, root / "lp", *batch))
            t = time.perf_counter()
            path = lp.dump(*setup)  # the loader's decode and the encode
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            got = dict(cuda_lib.LAUNCHES)
            for key, n in cuda_lib.LAUNCH_SHAPES.items():
                shapes[key] = shapes.get(key, 0) + n
            launches = got if launches is None else {k: launches[k] + got[k] for k in got}
            with np.load(path) as data:
                feats, labels = data["feature_list"], data["label_list"]
            n, batches = len(labels), -(-len(labels) // LPCLIP_BATCH)
            # K1 and K2 once a block of the 12, no other kernel (the attention
            # core and the GEMM launch inside them)
            want = {"fused_attn_half": 12 * batches, "fused_mlp_half": 12 * batches}
            if {k: v for k, v in got.items() if v and k not in ("attn_core", "gemm_wgmma")} != want:
                raise AssertionError(f"[lpclip] {split}: launches {got}, expected {want}")
            norms = np.linalg.norm(feats, axis=1)
            if feats.shape != (n, 512) or not np.isfinite(feats).all() or np.allclose(norms, 1.0):
                raise AssertionError(f"[lpclip] {split}: features {feats.shape}, norms "
                                     f"{norms.min():.3g}-{norms.max():.3g}")
            print(f"[lpclip] {split}: {n} images in {wall:.2f} s = {n / wall:.1f} images/s "
                  f"(the loader's decode and the encode, to a synchronise; the tower's first "
                  f"call in 'train'), {batches} batches of {LPCLIP_BATCH}, launches K1 "
                  f"{got['fused_attn_half']} K2 {got['fused_mlp_half']} (12 + 12 a batch), peak "
                  f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, feature norms "
                  f"{norms.min():.3g}-{norms.max():.3g}", flush=True)
        os.environ["OVMR_SYNTHETIC"] = LPCLIP_FP32_SYNTHETIC
        fp32 = {}
        for device in ("cuda", "cpu"):
            path = lp.main(args("test", root / f"lp-fp32-{device}", "CUDA.DEVICE", device,
                                "CUDA.DTYPE", "float32", "DATALOADER.TEST.BATCH_SIZE", "4"))
            with np.load(path) as data:
                fp32[device] = data["feature_list"]
        err = float(np.abs(fp32["cuda"] - fp32["cpu"]).max())
        scale = float(np.abs(fp32["cpu"]).max())
        print(f"[lpclip] fp32 features card vs cpu ({len(fp32['cpu'])} images): max abs err "
              f"{err:.3g}, scale {scale:.3g}, {err / scale:.3g} of it (gate {LPCLIP_FP32_TOL})",
              flush=True)
        if not err <= LPCLIP_FP32_TOL * scale:
            raise AssertionError(f"[lpclip] fp32 features off by {err:.3g} (scale {scale:.3g})")
    finally:
        if saved is None:
            os.environ.pop("OVMR_SYNTHETIC", None)
        else:
            os.environ["OVMR_SYNTHETIC"] = saved
    return launches, shapes


def ssl_phase(torch, np, root: Path):
    """Phase 22: a CIFAR-10 tree under ``root``, each SSL trainer's
    card-vs-CPU gate, the six runs through the entry point, then lpclip's
    extractor. Returns every run's (launches, shapes)."""
    t0 = time.perf_counter()
    # torch's own TF32 defaults, as a user's process has them, for the whole
    # phase: the entry points and the Dassl steps must turn TF32 off themselves
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True
    try:
        n = write_cifar10(np, root)
        print(f"[ssl] CIFAR-10 tree: {n} images ({len(CIFAR10_CLASSES)} classes x "
              f"{CIFAR10_TRAIN} + {CIFAR10_TEST}) in {time.perf_counter() - t0:.1f} s", flush=True)
        t = time.perf_counter()
        for tag in ("fixmatch", "sup_baseline", "entmin", "mean_teacher", "mixmatch"):
            ssl_card_vs_cpu(torch, np, root, tag)
            torch.cuda.empty_cache()
        print(f"[ssl] the gates in {time.perf_counter() - t:.1f} s", flush=True)
        paths = {}
        for tag in SSL_RUNS:
            _, paths[f"ssl_{tag}"] = ssl_run(torch, np, root, tag)
            torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    paths["lpclip"] = lpclip_phase(torch, np, root)
    print(f"[ssl] phase 22 in {time.perf_counter() - t0:.1f} s", flush=True)
    return paths


# ---------------------------------------------------------------------------
# phase 23: the whole-batch Dassl trainers on two gloo ranks sharing the card
# ---------------------------------------------------------------------------

# the trainers whose losses span the whole batch, each at its phase's gate
# (the recipe, the gate's cut of the lr and its batches): DAELDG at PACS's
# (phase 20), M3SDA, DAEL and CDAC at Digit-5's (phase 21), MixMatch at
# CIFAR-10's FixMatch recipe with two views (phase 22)
PG_TRAINERS = ("daeldg", "m3sda", "dael", "cdac", "mixmatch", "vanilla_ms", "vanilla_efdmix")
# Vanilla at PACS's gate (phase 20) on the mixing ResNet-18s, their coin at
# 1 so that every forward mixes: MixStyle / EFDMix after layer1-3, each rank
# mixing its rows with partners drawn over the whole batch
PG_MIXING = {"vanilla_ms": "resnet18_ms_l123", "vanilla_efdmix": "resnet18_efdmix_l123"}
# the mixing calls of the two gate steps: three layers a forward
PG_MIXING_CALLS = 6
# EFDMix's gate steps run in float64 (models and batches), as the CPU tests
# replay theirs: EFDMix matches sorted feature values, so a change that
# swaps two of them moves its steps by tens of gates, as a 1e-6 input change
# does (phase 23 prints that drift in both precisions); a reordered sum's
# last float32 bit swaps some, its last float64 bit none
PG_FLOAT64 = ("vanilla_efdmix",)
# each rank-local control must read at least this many times some gate
PG_CONTROL_FACTOR = 10
# DAEL through the entry point on the two ranks: the Digit-5 tree's 200
# images a source domain give the recipe's batch of 256 (4 x 64) three
# steps an epoch, 384 (4 x 96) two
PG_DAEL_BATCH = 384
PG_WAIT_S = 600  # a rank's wait for the one-process run's states and batches


def _pg_trainer(torch, root, tag, device="cuda", float64=None):
    """``tag``'s gate trainer, as its phase builds it (under a process group
    its data axis spans the ranks); the mixing Vanillas with their coin at
    1, in float64 for the tags of :data:`PG_FLOAT64` (or as ``float64``
    says)."""
    if tag in PG_MIXING:
        trainer = _dg_trainer(torch, root, "vanilla", device, [
            *_dg_gate_opts(root, "vanilla"), "MODEL.BACKBONE.NAME", PG_MIXING[tag]])
        trainer.net.backbone.ms_p = 1.0
        if tag in PG_FLOAT64 if float64 is None else float64:
            trainer.net.double()

            def rows64(x, local=False, rows=trainer.rows):
                t = rows(x, local)
                return t.double() if t.is_floating_point() else t

            trainer.rows = rows64
        return trainer
    if tag in DG_RUNS:
        return _dg_trainer(torch, root, tag, device, _dg_gate_opts(root, tag))
    if tag in SSL_RUNS:
        return _ssl_trainer(torch, root, tag, device, _ssl_gate_opts(root, tag))
    return _da_trainer(torch, root, tag, device, _da_gate_opts(root, tag))


def _pg_replay(torch, np, trainer, init, batches, tag, scale=None):
    """``tag``'s two gate steps (the images times ``1 + scale`` when given);
    for the mixing Vanillas also whether each mixing call mixed (a skipped
    call returns its input)."""
    if tag not in DG_RUNS and tag not in PG_MIXING:
        return _da_replay(torch, np, trainer, init, batches, tag)
    from ovmr_tpu_torch.modeling import ops

    applied, saved = [], (ops.mixstyle, ops.efdmix)

    def counted(fn):
        def call(x, *args, **kwargs):
            out = fn(x, *args, **kwargs)
            applied.append(out is not x)
            return out
        return call

    ops.mixstyle, ops.efdmix = counted(saved[0]), counted(saved[1])
    try:
        run = _dg_replay(np, trainer, init, batches, tag, scale)
    finally:
        ops.mixstyle, ops.efdmix = saved
    if tag in PG_MIXING and applied != [True] * PG_MIXING_CALLS:
        raise AssertionError(f"[pg] {tag}: the mixing calls of the two steps mixed {applied}, "
                             f"not {PG_MIXING_CALLS} times")
    return run


def _pg_write(obj, path: Path) -> None:
    """The states and batches the parent and the ranks hand each other
    (numpy arrays in dicts, ~1 GB), pickled with protocol 5, which writes an
    array's bytes as they are (``torch.save`` pickles numpy arrays through
    protocol 2, far slower at this size)."""
    import pickle

    with open(path, "wb") as f:
        pickle.dump(obj, f, protocol=5)


def _pg_read(path: Path):
    import pickle

    with open(path, "rb") as f:
        return pickle.load(f)


def _rank_local(trainer):
    """The control: ``trainer`` with its cross-rank step made rank-local.
    Its gathers and blocks are this rank's rows, its domain groups a
    reshape of its own block and its step scope mixes features within the
    rank (``ops.rank_local_mixing``), so the moments, the similarities, the
    domain groups, MixMatch's shuffle and MixStyle/EFDMix span this rank's
    rows only."""
    from ovmr_tpu_torch.modeling import ops

    trainer.gather_rows = lambda x: x
    trainer.own_rows = lambda x: x
    trainer.domain_groups = lambda x, n, split: [
        (rows, 0) for rows in x.reshape((n, -1) + tuple(x.shape[1:]))]
    scope = trainer.step_scope

    @contextlib.contextmanager
    def local_mixing_scope(*rows):
        with scope(*rows) as gen, ops.rank_local_mixing():
            yield gen

    trainer.step_scope = local_mixing_scope
    return trainer


def _pg_rank(rank, world, root):
    """One rank of phase 23: joins a gloo group of ``world`` ranks on the one
    card; replays each trainer's two gate steps from the one-process run's
    state and batches (``refs.pt``) with the same draws, then its rank-local
    control; then trains DAEL through ``ovmr_tpu_torch.train.main`` for
    two steps with the sliced loader. Saves its readings for the parent."""
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    import torch.distributed as dist

    from ovmr_tpu_torch import train as entry
    from ovmr_tpu_torch.engine import da
    from ovmr_tpu_torch.ops import cuda_lib

    root = Path(root)
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{root}/pg/rendezvous", rank=rank,
                            world_size=world)
    try:
        cuda_lib.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        # each trainer and its control, built while the parent takes the
        # one-process steps
        trainers, builds = {}, {}
        for tag in PG_TRAINERS:
            t = time.perf_counter()
            trainers[tag] = (_pg_trainer(torch, root, tag),
                             _rank_local(_pg_trainer(torch, root, tag)))
            builds[tag] = time.perf_counter() - t
            if trainers[tag][0].axis is None or trainers[tag][0].axis.group is None:
                raise AssertionError(f"[pg] rank {rank}: {tag} has no data axis over the ranks")
        refs_path, deadline = root / "pg" / "refs.pt", time.perf_counter() + PG_WAIT_S
        while not refs_path.exists():
            if time.perf_counter() > deadline:
                raise TimeoutError(f"[pg] rank {rank}: no {refs_path} after {PG_WAIT_S} s")
            time.sleep(0.1)
        refs = _pg_read(refs_path)
        out = {}
        with _host_draws(torch):
            for tag in PG_TRAINERS:
                init, batches, _ = refs[tag]
                t = time.perf_counter()
                run = _pg_replay(torch, np, trainers[tag][0], init, batches, tag)
                walls = [builds[tag], time.perf_counter() - t]
                control = _pg_replay(torch, np, trainers[tag][1], init, batches, tag)
                walls.append(time.perf_counter() - t - walls[1])
                out[tag] = {"run": run, "control": control, "walls": walls}
                del trainers[tag]
                torch.cuda.empty_cache()
        launches = dict(cuda_lib.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        seen = []
        orig = da.DAEL.forward_backward_xu

        def recording(self, batch_x, batch_u):
            result = orig(self, batch_x, batch_u)
            seen.append((result["loss"], bool(batch_x.get("_local", False)),
                         len(batch_x["label"])))
            return result

        da.DAEL.forward_backward_xu = recording
        t = time.perf_counter()
        argv = da_argv(root, root / "pg" / f"dael-rank{rank}", "dael", [
            "DATALOADER.TRAIN_X.BATCH_SIZE", str(PG_DAEL_BATCH), "TEST.NO_TEST", "True",
            "TRAIN.PRINT_FREQ", "1"])
        run_entry(entry.build_parser(), entry, argv)
        torch.cuda.synchronize()
        entry_s = time.perf_counter() - t
        _pg_write({"out": out, "launches": launches, "peak": peak, "seen": seen,
                   "entry_s": entry_s, "entry_launches": dict(cuda_lib.LAUNCHES)},
                  root / "pg" / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _pg_drifts(torch, np, root, tag, init, batches, ref):
    """A mixing Vanilla's one process on the card against itself under a
    1e-6 input change (the gates' noise floor): in the precision its gate
    runs in and, for a float64 gate, in float32 too."""
    def drift(float64):
        base = ref if float64 == (tag in PG_FLOAT64) else _pg_replay(
            torch, np, _pg_trainer(torch, root, tag, float64=float64), init, batches, tag)
        moved = _pg_replay(torch, np, _pg_trainer(torch, root, tag, float64=float64), init,
                           batches, tag, scale=DG_PERTURB)
        return _dg_compare(np, moved, base, init, tag)

    out = {"": drift(tag in PG_FLOAT64)}
    if tag in PG_FLOAT64:
        out[" in float32"] = drift(False)
    return out


def _states_equal(np, a, b) -> bool:
    """Two runs' losses and states bit for bit."""
    flat_a = {n: dict(_dg_flat(state)) for n, state in a[2].items()}
    flat_b = {n: dict(_dg_flat(state)) for n, state in b[2].items()}
    return a[0] == b[0] and all(
        flat_a[n].keys() == flat_b[n].keys() and all(np.array_equal(v, flat_b[n][k])
                                                     for k, v in flat_a[n].items())
        for n in flat_a)


def pg_phase(torch, np, root=None):
    """Phase 23: phases 20-22's trees (under ``root``; written anew in a
    directory of its own when None), then each whole-batch trainer's two
    gate steps on the card in one process, the same steps on two gloo ranks
    sharing the card (NCCL refuses two ranks on one card), each holding its
    block of every batch, held against the one process at phases 20-22's
    gates and bit for bit against each other, and the rank-local control,
    which must fail them; then DAEL through ``ovmr_tpu_torch.train.main``
    on the two ranks with the sliced loader (losses equal on both, the npz
    written by rank 0 alone)."""
    import os

    import torch.multiprocessing as mp

    from ovmr_tpu_torch.ops import cuda_lib

    t0 = time.perf_counter()
    own = root is None
    root = Path(tempfile.mkdtemp(prefix="ovmr_pg_smoke_")) if own else root
    (root / "pg").mkdir()
    # torch's own TF32 defaults, as in phases 20-22 (and in the ranks)
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True
    try:
        if own:
            n = write_pacs(np, root) + write_da_trees(np, root) + write_cifar10(np, root)
            print(f"[pg] PACS, Office-31, Digit-5 and CIFAR-10 trees: {n} images in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
        t = time.perf_counter()
        # the two ranks' gloo traffic over the loopback interface, unless the
        # caller chose one: on the card's machine a 64-float all-reduce takes
        # 3.8-4.5 ms over the default interface, 1.2-1.5 ms over lo (PERF.md)
        ifname = os.environ.get("GLOO_SOCKET_IFNAME")
        os.environ["GLOO_SOCKET_IFNAME"] = ifname or "lo"
        try:
            # the ranks start (the imports, the card, the process group, the
            # trainers) while this process takes the one-process steps, which
            # they then read
            ranks_run = mp.spawn(_pg_rank, args=(2, str(root)), nprocs=2, join=False)
        finally:
            if ifname is None:
                os.environ.pop("GLOO_SOCKET_IFNAME")
        try:
            refs, drifts = {}, {}
            cuda_lib.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            with _host_draws(torch):
                for tag in PG_TRAINERS:
                    card = _pg_trainer(torch, root, tag)
                    init = {name: card.model_state(name) for name in card.get_model_names()}
                    if tag in DG_RUNS or tag in PG_MIXING:
                        batches = _two_batches(card.train_loader)
                    else:
                        batches = list(zip(_two_batches(card.dm.train_loader_x),
                                           _two_batches(card.dm.train_loader_u)))
                    refs[tag] = (init, batches, _pg_replay(torch, np, card, init, batches, tag))
                    del card
                    if tag in PG_MIXING:
                        drifts[tag] = _pg_drifts(torch, np, root, tag, *refs[tag])
                    torch.cuda.empty_cache()
            launches = dict(cuda_lib.LAUNCHES)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            _pg_write(refs, root / "pg" / "refs.part")
            (root / "pg" / "refs.part").replace(root / "pg" / "refs.pt")
            refs_s = time.perf_counter() - t
            while not ranks_run.join():
                pass
        finally:
            for proc in ranks_run.processes:
                if proc.is_alive():
                    proc.terminate()
                    proc.join()
        spawn_s = time.perf_counter() - t - refs_s
        ranks = [_pg_read(root / "pg" / f"rank{r}.pt") for r in range(2)]
        for tag in PG_TRAINERS:
            init, batches, ref = refs[tag]
            runs = [got["out"][tag]["run"] for got in ranks]
            held = {f"rank {r} vs one process": _dg_compare(np, run, ref, init, tag)
                    for r, run in enumerate(runs)}
            controls = {f"rank {r} rank-local vs one process":
                        _dg_compare(np, got["out"][tag]["control"], ref, init, tag)
                        for r, got in enumerate(ranks)}
            rows = (f"{len(batches[0][0]['label'])} + {len(batches[0][1]['label'])}"
                    if isinstance(batches[0], tuple) else len(batches[0]["label"]))
            build_s, run_s, control_s = ranks[0]["out"][tag]["walls"]
            print(f"[pg] {tag} (batch {rows}, 2 steps; the warm step {1e3 * ref[1][1]:.1f} ms "
                  f"in one process, {1e3 * runs[0][1][1]:.1f} / {1e3 * runs[1][1][1]:.1f} ms "
                  f"on the two ranks, unprofiled; rank 0's builds of it and its control "
                  f"{build_s:.1f} s, its steps {run_s:.1f} s, the control's {control_s:.1f} s): "
                  + "; ".join(_dg_line(k, v) for k, v in held.items())
                  + "; controls: " + "; ".join(_dg_line(k, v) for k, v in controls.items()),
                  flush=True)
            if tag in drifts:
                print(f"[pg] {tag} in {'float64' if tag in PG_FLOAT64 else 'float32'}; one "
                      f"process' losses {ref[0]}, rank 0's {runs[0][0]}; "
                      + "; ".join(_dg_line(f"the one process under a 1e-6 input change{k}", v)
                                  for k, v in drifts[tag].items()), flush=True)
            for key, (loss_ratio, leaf_ratio, (leaf, err, scale), _) in held.items():
                if loss_ratio > 1 or leaf_ratio > 1:
                    raise AssertionError(f"[pg] {tag} {key}: losses at {loss_ratio:.3g} of their "
                                         f"gate, {leaf} off by {err:.3g} (scale {scale:.3g}) at "
                                         f"{leaf_ratio:.3g} of its gate")
            for key, (loss_ratio, leaf_ratio, _, _) in controls.items():
                if max(loss_ratio, leaf_ratio) < PG_CONTROL_FACTOR:
                    raise AssertionError(f"[pg] {tag} control {key} read {loss_ratio:.3g} / "
                                         f"{leaf_ratio:.3g} of the gates, under "
                                         f"{PG_CONTROL_FACTOR}x: the gates cannot tell it "
                                         f"from the path")
            if not _states_equal(np, runs[0], runs[1]):
                raise AssertionError(f"[pg] {tag}: the two ranks' losses or states differ")
        for r, got in enumerate(ranks):
            if any(got["launches"].values()) or any(got["entry_launches"].values()):
                raise AssertionError(f"[pg] rank {r} launched K1-K8: {got['launches']}, "
                                     f"{got['entry_launches']}")
        if any(launches.values()):
            raise AssertionError(f"[pg] the one-process steps launched K1-K8: {launches}")
        half = PG_DAEL_BATCH // 2
        for r, got in enumerate(ranks):
            if [(local, rows) for _, local, rows in got["seen"]] != [(True, half)] * 2:
                raise AssertionError(f"[pg] DAEL entry run, rank {r}: batches {got['seen']}")
        losses = [[loss for loss, _, _ in got["seen"]] for got in ranks]
        if losses[0] != losses[1] or not all(math.isfinite(v) for v in losses[0]):
            raise AssertionError(f"[pg] DAEL entry run: losses differ across the ranks: {losses}")
        written = [(root / "pg" / f"dael-rank{r}" / name / "model-1.npz").is_file()
                   for r in range(2) for name in ("F", "E")]
        if written != [True, True, False, False]:
            raise AssertionError(f"[pg] DAEL entry run: npz written {written}, not by rank 0 alone")
        print(f"[pg] DAEL through train.main on the two ranks, the sliced loader: 2 steps, "
              f"{half} source rows a rank a step, losses {losses[0]} on both, npz by rank 0 "
              f"alone, run wall {ranks[0]['entry_s']:.1f} s; the one-process steps with "
              f"their builds, batches and drifts {refs_s:.1f} s (while the ranks started "
              f"and built theirs), the ranks after them {spawn_s:.1f} s; peak memory "
              f"{peak:.2f} GiB in one process, "
              f"{ranks[0]['peak']:.2f} / {ranks[1]['peak']:.2f} GiB on the ranks; K1-K8 "
              f"launches 0", flush=True)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
        shutil.rmtree(root if own else root / "pg", ignore_errors=True)
    print(f"[pg] phase 23 in {time.perf_counter() - t0:.1f} s", flush=True)


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
    t_lap = [time.perf_counter()]

    def lap(what):
        """The wall since the last lap, one line a group of phases."""
        now = time.perf_counter()
        print(f"[wall] {what}: {now - t_lap[0]:.1f} s", flush=True)
        t_lap[0] = now

    from ovmr_tpu_torch.api import OVMRGenerator
    from ovmr_tpu_torch.models import clip as tclip
    from ovmr_tpu_torch.models.aggregator import init_aggregator

    kernels, cases = kernel_checks(torch, F)
    block_case = cases["block"]
    lap("phase 2 (kernels against their plain versions)")

    def all_checked(what, shapes):
        """Every launch of a path ran at a shape phase 2 (or, for phase 18's
        draws, ``block_case`` after it) held and timed."""
        checked = {entry["shape_key"] for entry in kernels}
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
    lap("phases 3-6 (ViT-B/16 serving and training)")

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
    lap("phases 7-11 (ViT-L/14@336px, the model axis, the vision backward)")
    work = Path(tempfile.mkdtemp(prefix="ovmr_trainer_smoke_"))
    try:
        *paths["trainer"], bf16_eval = trainer_phase(torch, np, work)
        all_checked("trainer", paths["trainer"][1])
        torch.cuda.empty_cache()
        lap("phase 12 (the trainer)")
        paths["trainer_augs"] = augs_trainer_phase(torch, np, work)
        all_checked("trainer_augs", paths["trainer_augs"][1])
        torch.cuda.empty_cache()
        lap("phase 13 (the device-augmented trainer)")
        t = time.perf_counter()
        paths["stage2"], paths["stage2_imagenet"] = stage2_phase(torch, np, work)
        all_checked("stage2", paths["stage2"][1])
        all_checked("stage2_imagenet", paths["stage2_imagenet"][1])
        print(f"[stage2] phase 14 in {time.perf_counter() - t:.1f} s", flush=True)
        torch.cuda.empty_cache()
        t = time.perf_counter()
        paths["zeroshot"], paths["clip_compat"] = zeroshot_phase(torch, np, work)
        all_checked("zeroshot", paths["zeroshot"][1])
        all_checked("clip_compat", paths["clip_compat"][1])
        print(f"[zeroshot] phase 15 in {time.perf_counter() - t:.1f} s", flush=True)
        torch.cuda.empty_cache()
        t = time.perf_counter()
        for path, recorded in resnet_phase(torch, np, work).items():
            paths[path] = recorded
            all_checked(path, recorded[1])
        print(f"[rn] phase 16 in {time.perf_counter() - t:.1f} s", flush=True)
        torch.cuda.empty_cache()
        t = time.perf_counter()
        paths["int8"] = int8_phase(torch, np, work, bf16_eval)
        all_checked("int8", paths["int8"][1])
        print(f"[int8] phase 17 in {time.perf_counter() - t:.1f} s", flush=True)
        torch.cuda.empty_cache()
        t = time.perf_counter()
        paths["multires"], fp32_shapes = multires_phase(torch, np, work)
        torch.cuda.empty_cache()
        # the collate's draws are known only now: hold the kernels at each
        drawn_block_checks(torch, block_case, {entry["shape_key"] for entry in kernels},
                           paths["multires"][1], fp32_shapes)
        all_checked("multires", paths["multires"][1])
        all_checked("multires-fp32", fp32_shapes)
        print(f"[multires] phase 18 in {time.perf_counter() - t:.1f} s", flush=True)
        torch.cuda.empty_cache()
        gloo_ranks_phase(torch, work)  # phase 19 (d), over phase 12's data
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    for path, recorded in data_axis_phase(torch, np, clip_params, agg_params, cases,
                                          kernels).items():
        paths[path] = recorded
        all_checked(path, recorded[1])
    torch.cuda.empty_cache()
    lap("phases 14-19")
    # phases 20-22 write their trees under one root, which phase 23 reads
    dassl_root = Path(tempfile.mkdtemp(prefix="ovmr_dassl_smoke_"))
    try:
        paths.update(dg_phase(torch, np, dassl_root))  # phase 20: no K1-K8 on the DG paths
        lap("phase 20")
        paths.update(da_phase(torch, np, dassl_root))  # phase 21: no K1-K8 on the DA paths
        lap("phase 21")
        # phase 22: no K1-K8 launch on the SSL paths; lpclip's K1/K2 at the
        # test pass' shape phase 2 held
        paths.update(ssl_phase(torch, np, dassl_root))
        all_checked("lpclip", paths["lpclip"][1])
        lap("phase 22")
        # phase 23: no K1-K8 launch on the process-group Dassl paths
        pg_phase(torch, np, dassl_root)
        lap("phase 23")
    finally:
        shutil.rmtree(dassl_root, ignore_errors=True)

    for entry in kernels:
        # launches: the wrapper's count over the three ViT-B/16 requests +
        # classify, the three timed training steps, the two ViT-L/14@336px
        # requests + classify, the two on a model axis of 2 + classify,
        # phase 12's and phase 13's three trainer runs each, phase 14's three
        # stage-2 runs and its nine timed 1000-class steps, phase 15's
        # zero-shot run and its bf16 clip_compat forward, phase 16's RN50
        # clip_compat forward, zero-shot run and CoOp run and RN101's two
        # requests + classify, phase 17's int8 eval and phase 18's four
        # drawn steps (each read with the counts zeroed just before);
        # launches_at_shape:
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
