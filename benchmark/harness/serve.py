"""Closed-loop classifier generation: ``OVMRGenerator.generate`` (exemplar
images in) or ``generate_from_features`` (cached exemplar features in).

One client sends a request, waits for the classifiers, and sends the next.
The mix's class counts are a fixed list; every pass over it is a fresh
permutation drawn from the seed, so every seed sends the same sizes in
another order. A request of ``n`` classes takes ``n`` consecutive class sets
of the exemplar pool (images, or unit features, made on the device from the
seed: a prototype per class plus noise per exemplar) and ``n`` distinct LVIS
names.

``correct``: once the window has closed, a sample of the finished requests
drawn from the seed (with the first of the largest size) is worked out again
by the plain reference in float32 (:meth:`Serve.check`).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import work
from benchmark.harness import common
from benchmark.reference import nn as ref_nn
from benchmark.reference import ovmr as ref_ovmr

CLASSIFIERS = ("mm_classifier", "vision_classifier", "text_classifier")


class Serve:
    def __init__(self, cell: common.Cell, variant=None):
        from ovmr_tpu_torch.api import OVMRGenerator
        from ovmr_tpu_torch.models import ovmr

        self.cell = cell
        cfg, traffic = cell.config, cell.traffic
        self.encode = traffic["entry"] == "generate"
        self.shots = traffic["shots"]
        self.tau = float(traffic["eval_tau"])
        dev = cell.device
        gen = torch.Generator(device=dev).manual_seed(cell.seed)
        self.weights = common.make_weights(cfg, gen, dev)
        clip = self.weights["clip"]
        if variant not in (None, "int8", "fp8"):
            raise ValueError(f"serving variant {variant!r}")
        self.variant = variant
        if variant == "int8":  # the program's own int8 serving path: a control
            from ovmr_tpu_torch.ops.quant import quantize_params

            clip = quantize_params(clip)
        self.program = None
        if variant != "fp8":  # fp8: the reference in float8, in the program's place
            self.program = OVMRGenerator(clip, common.clip_config(cfg), self.weights["agg"],
                                         dtype=common.DTYPES[cfg["dtype"]], device=dev)
        self.names = common.lvis_names(cell.root)
        sizes = traffic["classes"]
        self.pool_classes = max(traffic.get("pool_classes", 0), max(sizes))
        self.pool = self._pool(gen)
        self.rng = np.random.default_rng([cell.seed, 1])
        self.sizes = sizes
        self.fp8_feats = {}
        # the program's tokenizer cache, as a served vocabulary leaves it
        ovmr.build_prompt_tokens(self.names)

    def _pool(self, gen):
        """Exemplars [pool_classes, shots, ...]: CLIP-normalised pixels, or
        unit features in the served dtype."""
        cfg, p, k, dev = self.cell.config, self.pool_classes, self.shots, self.cell.device
        noise = self.cell.traffic["exemplar_noise"]
        if self.encode:
            r = cfg["image_resolution"]
            pool = torch.randn((p, k, 3, r, r), generator=gen, device=dev)
            proto = torch.randn((p, 1, 3, r, r), generator=gen, device=dev)
            return pool.mul_(noise).add_(proto)
        d = cfg["embed_dim"]
        pool = torch.randn((p, k, d), generator=gen, device=dev).mul_(noise)
        pool += torch.randn((p, 1, d), generator=gen, device=dev)
        pool /= pool.norm(dim=-1, keepdim=True)
        return pool.to(common.DTYPES[cfg["dtype"]])

    def plan(self):
        """Requests (n, first class set, names) for ever, from the seed."""
        while True:
            for n in self.rng.permutation(self.sizes):
                n = int(n)
                start = int(self.rng.integers(0, self.pool_classes - n + 1))
                names = [self.names[i] for i in self.rng.choice(len(self.names), n, replace=False)]
                yield n, start, names

    def call(self, req):
        n, start, names = req
        x = self.pool[start:start + n]
        if self.program is None:
            return self._reference_fp8(n, names, x)
        if self.encode:
            return self.program.generate(names, x, eval_tau=self.tau)
        return self.program.generate_from_features(names, x, eval_tau=self.tau)

    def _reference_fp8(self, n, names, x):
        """The control: the reference's outputs with float8 operands."""
        w32 = common.reference_weights(self.weights)
        with torch.no_grad(), ref_nn.precision("fp8"):
            feats = self._reference_features(w32, n, x)
            out = ref_ovmr.classifiers(w32, self.cell.config, names, feats)
            out["fusion_weight"] = ref_ovmr.fusion(
                feats, [out[k] for k in CLASSIFIERS], w32["logit_scale"], self.tau, 0.0)[0]
        self.fp8_feats[(n, names[0])] = feats
        return {k: v.cpu().numpy() for k, v in out.items()}

    def _reference_features(self, w32, n, x):
        if not self.encode:
            return x.float()
        flat = x.reshape(n * self.shots, *x.shape[2:])
        return ref_nn.encode_image(w32["visual"], self.cell.config, flat).reshape(n, self.shots, -1)

    def warm(self):
        """One request of every size of the mix."""
        if self.program is None:
            return
        plan = self.plan()
        seen = set()
        while len(seen) < len(set(self.sizes)):
            req = next(plan)
            if req[0] not in seen:
                seen.add(req[0])
                self.call(req)

    def window(self, seconds, on_start=None):
        """The measured loop; returns a :class:`common.Window`."""
        cfg = self.cell.config
        sample_k = int(self.cell.limits["sample_requests"])
        keep_rng = np.random.default_rng([self.cell.seed, 2])
        w = common.Window()
        kept, largest = [], None
        plan = self.plan()
        common.sync(self.cell.device)
        t_start = time.perf_counter()
        if on_start:
            on_start()
        deadline = t_start + seconds
        while True:
            req = next(plan)
            with torch.profiler.record_function("request"):
                t0 = time.perf_counter()
                out = self.call(req)
                t1 = time.perf_counter()
            n = req[0]
            w.latencies.append(t1 - t0)
            w.count("requests", 1)
            w.count("classes", n)
            if self.encode:
                w.count("images", n * self.shots)
            w.work += work.generate_request(cfg, n, self.shots, self.encode)
            i = len(w.latencies) - 1
            if largest is None and n == max(self.sizes):
                largest = (req, out)
            elif len(kept) < sample_k:
                kept.append((req, out))
            else:  # reservoir sample of the finished requests
                j = int(keep_rng.integers(0, i + 1))
                if j < sample_k:
                    kept[j] = (req, out)
            if t1 >= deadline:
                break
        w.seconds = t1 - t_start
        w.attempted = len(w.latencies)
        head = [largest] if largest else []
        self.sample = head + kept[:max(0, sample_k - len(head))]
        return w

    def fill_sample(self):
        """The sample without a window (the float8 control): the first
        request of the largest size and the next ones, up to
        ``sample_requests``."""
        k = int(self.cell.limits["sample_requests"])
        largest, others = None, []
        plan = self.plan()
        while largest is None or len(others) < k - 1:
            req = next(plan)
            if largest is None and req[0] == max(self.sizes):
                largest = (req, self.call(req))
            elif len(others) < k - 1:
                others.append((req, self.call(req)))
        self.sample = [largest] + others

    def free(self):
        """Drops the program; first, for ``generate``, its own exemplar
        features of the sampled requests, re-encoded at the request's batch
        by the entry the window drove, for the fusion checks."""
        self.prog_feats = []
        for (n, start, names), _ in self.sample:
            x = self.pool[start:start + n]
            if self.program is None:
                self.prog_feats.append(self.fp8_feats[(n, names[0])])
            elif self.encode:
                f = self.program.encode_images(x.reshape(n * self.shots, *x.shape[2:]))
                f = torch.as_tensor(f, device=x.device)
                self.prog_feats.append(f.reshape(n, self.shots, -1))
            else:
                self.prog_feats.append(x.float())
        self.program = None

    def check(self, limits):
        """The readings of the sampled requests; ``compared`` in the limits
        file names those that decide ``correct``.

        ``cls_cos_max`` and ``cls_cos_mean``: the largest and the mean cosine
        distance (1 - cos) between a classifier row (multi-modal, vision,
        text) and the reference's; ``vtok_rel_max``: the largest relative
        error of a visual token.

        Fusion, twice; a class's weights differ where they differ by more
        than 1e-6. ``fusion_ref_mismatch``: the classes whose weights differ
        from those of the reference's own fusion on its own float32 features
        and classifiers, among the classes that no exemplar row can flip: per
        classifier and row, the reference's runner-up logit lies further
        below its best than twice the row's largest logit gap between the
        program's features and classifiers and the reference's, plus
        ``tie_margin`` (the medians of the runner-up's gap and of that margin
        are reported). ``fusion_mismatch``: the classes whose weights differ
        from those that the reference's fusion gives on the program's own
        classifiers and exemplar features, among the classes that those
        logits settle at ``tie_margin`` (more classes, judged for
        consistency only)."""
        w32 = common.reference_weights(self.weights)
        scale = w32["logit_scale"]
        margin = float(limits["tie_margin"])
        cos, vtok, gaps = [], [], []
        tally = dict.fromkeys(("mismatch", "settled", "ref_mismatch", "ref_settled", "classes"), 0)
        for ((n, start, names), out), f_prog in zip(self.sample, self.prog_feats):
            with torch.no_grad():
                x = self.pool[start:start + n]
                feats = self._reference_features(w32, n, x)
                ref = ref_ovmr.classifiers(w32, self.cell.config, names, feats)
                dev = feats.device
                d = feats.shape[-1]
                cls3 = [torch.as_tensor(out[k], device=dev).float() for k in CLASSIFIERS]
                ref3 = [ref[k] for k in CLASSIFIERS]
                for got, want in zip(cls3, ref3):
                    cos.append(1 - torch.nn.functional.cosine_similarity(got, want, dim=-1))
                got = torch.as_tensor(out["visual_tokens"], device=dev).float().reshape(-1, d)
                want = ref["visual_tokens"].reshape(-1, d)
                vtok.append((got - want).norm(dim=-1) / want.norm(dim=-1))
                w_prog = torch.as_tensor(out["fusion_weight"], device=dev).float()
                w_self, det = ref_ovmr.fusion(f_prog, cls3, scale, self.tau, margin)
                off = (w_prog - w_self).abs().amax(dim=-1) > 1e-6
                tally["mismatch"] += int((off & det).sum())
                tally["settled"] += int(det.sum())
                rows_prog = f_prog.reshape(-1, d).float()
                rows_ref = feats.reshape(-1, d)
                margins = []
                for cp, cr in zip(cls3, ref3):
                    logits = scale * (rows_ref @ cr.T)
                    margins.append(2 * (scale * (rows_prog @ cp.T) - logits).abs().amax(dim=1)
                                   + margin)
                    top2 = logits.topk(2, dim=1).values
                    gaps.append(torch.stack([top2[:, 0] - top2[:, 1], margins[-1]]))
                w_ref, det = ref_ovmr.fusion(feats, ref3, scale, self.tau, margins)
                off = (w_prog - w_ref).abs().amax(dim=-1) > 1e-6
                tally["ref_mismatch"] += int((off & det).sum())
                tally["ref_settled"] += int(det.sum())
                tally["classes"] += n
        cos, vtok = torch.cat(cos), torch.cat(vtok)
        gaps = torch.cat(gaps, dim=1).median(dim=1).values.tolist()
        numbers = {"cls_cos_max": float(cos.max()), "cls_cos_mean": float(cos.mean()),
                   "vtok_rel_max": float(vtok.max()),
                   "fusion_ref_mismatch": float(tally["ref_mismatch"]),
                   "fusion_mismatch": float(tally["mismatch"])}
        return numbers, {"requests_checked": len(self.sample),
                         "classes_settled_ref": tally["ref_settled"],
                         "ref_runner_up_gap_median": gaps[0], "ref_row_margin_median": gaps[1],
                         "classes_settled": tally["settled"], "classes_checked": tally["classes"]}
