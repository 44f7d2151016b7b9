"""The generator's training step (MM_CLS_OP), as ``make_train_step`` runs it
with the device augmentation.

Set-up builds one step with its generator leaves and Adam, and drives it
through its first steps from the seed: ``check_steps`` steps that the
reference follows, then one per remaining split point so that every shape
of the window is warm. The window goes on with the same object. Step ``j``
takes batch ``j`` of a device pool of distinct uint8 batches (in a seeded
order), a split point from a seeded permutation of the mix's list, the
augmentation draws of the benchmark's own seeded generator (``augment_draws``)
and a dropout generator seeded per step.

``correct``: the plain reference replays the first ``check_steps`` steps in
float32 from the same leaves, images, draws and dropout draws (the same
``torch.rand`` calls on a generator with the same seed, in the program's
order: per layer the attention probabilities, the MLP hidden, the MLP
output). Compared: each step's loss (``loss_err``, relative), and by the
worst leaf the norm of the first gradient as Adam holds it after step one
(``grad_err``) and of the leaves' change over the checked steps
(``delta_err``): ``| |prog| - |ref| | / max(|ref|, median leaf's |ref|)``.
Leaves whose reference gradient is under a thousandth of the median leaf's
are left out of ``delta_err``.
"""

from __future__ import annotations

import math
import time
import types

import numpy as np
import torch

from benchmark import work
from benchmark.harness import common
from benchmark.reference import augment as ref_augment
from benchmark.reference import nn as ref_nn
from benchmark.reference import ovmr as ref_ovmr

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def _seed(*parts) -> int:
    return int(np.random.SeedSequence([int(p) for p in parts]).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


def leaves(agg: dict) -> list:
    """(name, tensor) of the generator's leaves, in the program's order
    (sorted keys)."""
    out = [(f"blocks.{k}", agg["blocks"][k]) for k in sorted(agg["blocks"])]
    return sorted([("cls_token", agg["cls_token"])] + out, key=lambda kv: kv[0])


class Train:
    def __init__(self, cell: common.Cell, variant=None):
        from ovmr_tpu_torch.engine.optimizers import build_optimizer
        from ovmr_tpu_torch.engine.train_step import make_train_step
        from ovmr_tpu_torch.models import ovmr

        self.cell = cell
        cfg, t = cell.config, cell.traffic
        dev = cell.device
        if variant not in (None, "fp8", "half_batch"):
            raise ValueError(f"training variant {variant!r}")
        self.variant = variant
        self.classes, self.instances = t["classes"], t["instances"]
        self.side, self.out = t["image_side"], cfg["image_resolution"]
        self.splits = t["split_points"]
        self.dropout = float(cfg["generator_dropout"])
        gen = torch.Generator(device=dev).manual_seed(cell.seed)
        self.weights = common.make_weights(cfg, gen, dev)
        self.agg = self.weights["agg"]
        self.pool = self._pool(gen)
        names = common.lvis_names(cell.root)
        rng = np.random.default_rng([cell.seed, 1])
        self.batch_names = [[names[i] for i in rng.choice(len(names), self.classes, replace=False)]
                            for _ in range(self.pool.shape[0])]
        self.prompts = []
        for bn in self.batch_names:
            ptok, eot, vis = ovmr.build_prompt_tokens(bn)
            self.prompts.append((torch.as_tensor(ptok, device=dev),
                                 torch.as_tensor(eot, device=dev)))
        self.vis = torch.as_tensor(vis, device=dev)
        self.order_rng = np.random.default_rng([cell.seed, 2])
        self.plan = []
        self.augment = dict(out_size=self.out, scale=tuple(t["rrc_scale"]),
                            jitter=tuple(t["jitter"]), gn_std=float(t["gn_std"]), mean=CLIP_MEAN,
                            std=CLIP_STD, out_dtype=common.DTYPES[cfg["dtype"]])
        if variant is None:
            for _, leaf in leaves(self.agg):
                leaf.requires_grad_(True)
            opt_cfg = types.SimpleNamespace(
                NAME="adam", LR=t["lr"], WEIGHT_DECAY=t["weight_decay"], ADAM_BETA1=0.9,
                ADAM_BETA2=0.999, MOMENTUM=0.0, SGD_NESTEROV=False, RMSPROP_ALPHA=0.99,
                STAGED_LR=False, NEW_LAYERS=(), BASE_LR_MULT=0.1)
            self.optimizer = build_optimizer(opt_cfg, self.agg)
            self.step_fn = make_train_step(common.clip_config(cfg), dropout=self.dropout,
                                           augment=self.augment)
        self.record = self.p0 = None

    def _pool(self, gen):
        """Distinct uint8 batches [P, classes, instances, side, side, 3]: a
        prototype per class plus noise per instance, around mid-grey."""
        t, dev = self.cell.traffic, self.cell.device
        shape = (t["pool_batches"], self.classes, self.instances, self.side, self.side, 3)
        pool = torch.empty(shape, dtype=torch.uint8, device=dev)
        for b in range(pool.shape[0]):
            x = torch.randn((self.classes, 1, self.side, self.side, 3), generator=gen, device=dev)
            x = x * 48 + 128 + 24 * torch.randn(pool.shape[1:], generator=gen, device=dev)
            pool[b] = x.clamp_(0, 255).to(torch.uint8)
        return pool

    # -- the plan of steps ---------------------------------------------------
    def step_plan(self, j: int):
        """(pool batch, split point) of step ``j``."""
        while len(self.plan) <= j:
            p = self.pool.shape[0]
            batches = self.order_rng.permutation(p)
            splits = self.order_rng.permutation(self.splits)
            n = max(p, len(splits))
            self.plan += [(int(batches[i % p]), int(splits[i % len(splits)])) for i in range(n)]
        return self.plan[j]

    def draws(self, j: int) -> dict:
        """The augmentation's draws of step ``j`` (every image's crop box,
        flip, jitter factors, hue angle, noise gate and noise), from a
        generator seeded by the step."""
        t, dev = self.cell.traffic, self.cell.device
        g = torch.Generator(device=dev).manual_seed(_seed(self.cell.seed, 3, j))
        b, s = self.classes * self.instances, self.side

        def u(lo, hi, n=b):
            return torch.rand(n, generator=g, device=dev) * (hi - lo) + lo

        area = u(*t["rrc_scale"]) * s * s
        ratio = torch.exp(u(math.log(3 / 4), math.log(4 / 3)))
        cw = torch.sqrt(area * ratio).clamp(max=s)
        ch = torch.sqrt(area / ratio).clamp(max=s)
        bri, con, sat, hue = t["jitter"]
        d = dict(cw=cw, ch=ch, x0=u(0, 1) * (s - cw), y0=u(0, 1) * (s - ch),
                 flip=u(0, 1) < 0.5, fb=u(1 - bri, 1 + bri), fc=u(1 - con, 1 + con),
                 fs=u(1 - sat, 1 + sat), fh=u(-hue, hue) * 2 * math.pi,
                 noise_gate=u(0, 1) < 0.5)
        d["noise"] = torch.randn((b, self.out, self.out, 3), generator=g, device=dev) * t["gn_std"]
        return d

    def dropout_generator(self, j: int) -> torch.Generator:
        return torch.Generator(device=self.cell.device).manual_seed(_seed(self.cell.seed, 4, j))

    def run_step(self, j: int):
        b, split = self.step_plan(j)
        ptok, eot = self.prompts[b]
        return self.step_fn(self.agg, self.optimizer, self.weights["clip"], self.pool[b], ptok, eot,
                            self.vis, self.dropout_generator(j), split,
                            augment_draws=self.draws(j))

    # -- set-up, window, check -------------------------------------------------
    def warm(self):
        """The checked steps, snapshotted, then a step of each split point
        not yet run."""
        n_check = int(self.cell.limits["check_steps"])
        if self.variant is not None:
            kw = ({"precision": "fp8"} if self.variant == "fp8"
                  else {"keep_classes": self.classes // 2})
            self.record = self.reference_steps(n_check, **kw)
            self.next_step = n_check
            return
        p0 = [leaf.detach().clone() for _, leaf in leaves(self.agg)]
        losses, grad0 = [], None
        for j in range(n_check):
            losses.append(self.run_step(j).item())
            if j == 0:
                b1 = self.optimizer.param_groups[0]["betas"][0]
                # a leaf the optimizer holds no moment of has not been stepped
                grad0 = [self.optimizer.state[leaf].get("exp_avg", torch.zeros_like(leaf))
                         / (1 - b1) for _, leaf in leaves(self.agg)]
        delta = [leaf.detach() - p for (_, leaf), p in zip(leaves(self.agg), p0)]
        self.record = {"losses": losses, "grad": grad0, "delta": delta}
        self.p0 = p0
        j = n_check
        seen = {self.step_plan(i)[1] for i in range(n_check)}
        while len(seen) < len(set(self.splits)):
            seen.add(self.step_plan(j)[1])
            self.run_step(j)
            j += 1
        self.next_step = j

    def window(self, seconds, on_start=None):
        cfg = self.cell.config
        w = common.Window()
        images = self.classes * self.instances
        n_params = sum(leaf.numel() for _, leaf in leaves(self.agg))
        common.sync(self.cell.device)
        t_start = time.perf_counter()
        if on_start:
            on_start()
        deadline = t_start + seconds
        j = self.next_step
        while time.perf_counter() < deadline:
            with torch.profiler.record_function("step"):
                self.run_step(j)
            split = self.step_plan(j)[1]
            w.work += work.train_step(cfg, self.classes, self.instances, split, self.side,
                                      self.out, n_params)
            w.count("steps", 1)
            w.count("images", images)
            j += 1
        common.sync(self.cell.device)
        w.seconds = time.perf_counter() - t_start
        w.attempted = w.counts.get("steps", 0)
        return w

    def free(self):
        self.step_fn = self.optimizer = None

    def reference_steps(self, n: int, precision="fp32", keep_classes=None):
        """The first ``n`` steps in plain PyTorch from the initial leaves:
        per step the loss; the first gradient; the leaves' change. Under
        ``precision="fp8"`` the control; ``keep_classes`` (a fault) takes the
        loss over the batch's first classes only."""
        cfg, dev = self.cell.config, self.cell.device
        w32 = common.reference_weights(self.weights)
        start = self.p0 if self.p0 is not None else [leaf for _, leaf in leaves(self.agg)]
        init = [p.detach().float().clone() for p in start]
        agg = {"blocks": {}, "cls_token": None}
        params = []
        for (name, _), p in zip(leaves(self.agg), init):
            p = p.clone().requires_grad_(True)
            params.append(p)
            if name == "cls_token":
                agg["cls_token"] = p
            else:
                agg["blocks"][name.split(".", 1)[1]] = p
        w32["agg"] = agg
        t = self.cell.traffic
        opt = ref_ovmr.Adam(params, lr=t["lr"], wd=t["weight_decay"])
        losses, grad = [], None
        chunk = 64
        with ref_nn.precision(precision):
            for j in range(n):
                b, split = self.step_plan(j)
                d = self.draws(j)
                names = self.batch_names[b]
                c = self.classes if keep_classes is None else keep_classes
                flat = self.pool[b].reshape(-1, self.side, self.side, 3)
                feats = []
                with torch.no_grad():
                    for s in range(0, flat.shape[0], chunk):
                        dd = {k: v[s:s + chunk] for k, v in d.items()}
                        x = ref_augment.augment(flat[s:s + chunk], dd, self.out, CLIP_MEAN,
                                                CLIP_STD)
                        feats.append(ref_nn.encode_image(w32["visual"], cfg, x.permute(0, 3, 1, 2)))
                feats = torch.cat(feats).reshape(self.classes, self.instances, -1)[:c]
                q = feats[:, :split].reshape(c * split, -1)
                e = feats[:, split:]
                rand_gen = self.dropout_generator(j)

                def rand(shape):
                    return torch.rand(shape, generator=rand_gen, device=dev)

                loss = ref_ovmr.loss(w32, cfg, q, e, names[:c], dropout=self.dropout, rand=rand)
                loss.backward()
                losses.append(loss.item())
                if j == 0:
                    grad = [(p.grad + opt.wd * p).detach() for p in params]
                opt.step()
        delta = [p.detach() - p0 for p, p0 in zip(params, init)]
        return {"losses": losses, "grad": grad, "delta": delta}

    def check(self, limits):
        ref = self.reference_steps(int(limits["check_steps"]))
        nums = compare_steps(self.record, ref)
        return nums, {"steps_checked": len(ref["losses"]),
                      "elements_left_out": nums.pop("elements_left_out")}


def compare_steps(prog: dict, ref: dict) -> dict:
    """The three readings of a program's (or a control's) checked steps
    against the reference's. Elements whose reference gradient is under a
    thousandth of the median leaf's root-mean-square gradient (nought to
    rounding, as a key's bias under softmax) move under Adam by round-off
    alone and are left out of ``delta_err``."""
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    g_prog = [float(g.norm()) for g in prog["grad"]]
    g_ref = [float(g.norm()) for g in ref["grad"]]
    g_med = float(np.median(g_ref))
    grad_err = max(abs(a - b) / max(b, g_med) for a, b in zip(g_prog, g_ref))
    rms_med = float(np.median([float(g.square().mean().sqrt()) for g in ref["grad"]]))
    keep = [g.abs() >= 1e-3 * rms_med for g in ref["grad"]]
    d_prog = [float(d[k].norm()) for d, k in zip(prog["delta"], keep)]
    d_ref = [float(d[k].norm()) for d, k in zip(ref["delta"], keep)]
    d_med = float(np.median(d_ref))
    delta_err = max(abs(a - b) / max(b, d_med) for a, b in zip(d_prog, d_ref))
    left_out = sum(int((~k).sum()) for k in keep)
    return {"loss_err": loss_err, "grad_err": grad_err, "delta_err": delta_err,
            "elements_left_out": left_out}
