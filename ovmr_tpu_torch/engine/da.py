"""Domain-adaptation trainers (reference ``dassl/engine/da/``): SourceOnly,
DANN, ADDA, AdaBN, MCD, MME, SE, M3SDA, DAEL, CDAC.

Counterpart of ``ovmr_tpu/engine/da.py``, with the JAX steps' order of
forwards and updates. A train-mode forward updates its BatchNorm's running
statistics where it runs, so the statistics a later phase of a step starts
from are those the JAX step threads into it; a forward under
``torch.no_grad`` still updates them, as the reference's does.

- DANN: one backward of ``CE + BCE(critic)`` through the gradient reversal
  (lambda annealed over the global step), then the model's and the critic's
  optimizers step (the reference's ``model_backward_and_update(loss)``
  steps every registered optimizer).
- ADDA: the eval-mode source model is a frozen copy of the
  ``MODEL.INIT_WEIGHTS`` state; one train-mode target forward feeds the
  critic's update (features detached) and then the model's (against the
  updated critic, whose train-mode forward keeps its BN update). The
  classifier is outside the model loss, so it has no gradient and no
  optimizer touches it (no decay either).
- AdaBN: the running statistics reset once, then train-mode target
  forwards re-estimate them; no optimizer steps.
- MCD / M3SDA: three phases a step (A: F and the classifiers on the source
  loss; B: the classifiers against the target discrepancy on features of
  no-grad forwards; C: F alone, ``N_STEP_F`` times). M3SDA forwards F once
  per source domain, so each domain's sub-batch is normalised by its own
  statistics, and reads the domain ids from the batch's domain vector.
- MME / CDAC: the cosine prototypes with the gradient reversal before the
  normalisation; CDAC anneals both optimizers' lr every iteration.
- SE: an EMA teacher (parameters only; its BN statistics from its own
  train-mode forwards) on the second of two views.
- DAEL: pseudo-labels from the most confident expert (a no-grad train-mode
  forward that advances F's statistics first), then one update of F and
  the experts.

M3SDA, DAEL and CDAC compute losses over the whole batch (domain groups,
moments, pairwise similarities). Under a process group each rank forwards
its rows of every domain group (:meth:`DasslTrainer.domain_groups`), and
the moments and the pairs take every rank's rows through
:meth:`DasslTrainer.gather_rows`, so every rank takes the single program's
update.
"""

from __future__ import annotations

import copy

import numpy as np
import torch
import torch.nn as nn

from ovmr_tpu_torch.convert import dassl_leaves
from ovmr_tpu_torch.data.manager import DataManager
from ovmr_tpu_torch.data.transforms import build_transform
from ovmr_tpu_torch.engine.dassl_base import (
    Critic,
    DasslTrainer,
    LinearHead,
    Prototypes,
    StackedLinears,
    TrainerXU,
    build_simplenet,
    expert_losses,
    split_views,
)
from ovmr_tpu_torch.engine.optimizers import set_lr
from ovmr_tpu_torch.engine.schedule import lr_schedule_from_cfg
from ovmr_tpu_torch.engine.trainer import TRAINER_REGISTRY
from ovmr_tpu_torch.modeling import ops as F
from ovmr_tpu_torch.models.resnet import exact_fp32_convolutions
from ovmr_tpu_torch.utils.tools import check_isfile


def _bce_with_logits(logits, targets):
    """torch BCEWithLogitsLoss (mean reduction)."""
    return (logits.clamp_min(0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs()))).mean()


class _SeparateModels(TrainerXU):
    """A trainer whose feature extractor ``F`` and heads are registered as
    models of their own (MCD, MME, M3SDA, DAEL, CDAC)."""

    def build_f(self):
        cfg = self.cfg
        print("Building F")
        self.net = self.build_net(build_simplenet(cfg, cfg.MODEL, 0))
        self.register_model("F", self.net, self.build_optim(self.net))

    def add_model(self, name, net):
        print(f"Building {name}")
        net = self.build_net(net)
        self.register_model(name, net, self.build_optim(net))
        return net

    @torch.no_grad()
    def infer(self, x, head):
        self.net.eval()
        with exact_fp32_convolutions():
            return head(self.net(x)).float().cpu().numpy()


@TRAINER_REGISTRY.register()
class SourceOnly(TrainerXU):
    """Supervised training on source batches only (reference
    ``da/source_only.py``)."""

    def forward_backward_xu(self, batch_x, batch_u):
        return DasslTrainer.forward_backward(self, batch_x)


@TRAINER_REGISTRY.register()
class DANN(TrainerXU):
    """Domain-adversarial training (reference ``da/dann.py``): GRL with the
    annealed lambda, BCE domain critic; one loss updates the model and the
    critic."""

    def build_model(self):
        super().build_model()
        fdim = self.net.fdim
        print("Building critic network")
        self.critic = self.build_net(Critic(fdim, (fdim, fdim)))
        self.register_model("critic", self.critic, self.build_optim(self.critic))

    def forward_backward_xu(self, batch_x, batch_u):
        img_x, label_x, _ = self.parse_batch_train(batch_x)
        img_u, _, _ = self.parse_batch_train(batch_u)
        global_step = self.batch_idx + self.epoch * self.num_batches
        progress = global_step / (self.max_epoch * self.num_batches)
        lmda = 2 / (1 + np.exp(-10 * progress)) - 1
        net, critic, s = self.net, self.critic, self.loss_scale
        net.train()
        critic.train()
        with self.step_scope(img_x.shape[0], img_u.shape[0]):
            logit_x, feat_x = net(img_x, return_feature=True)
            _, feat_u = net(img_u, return_feature=True)
            loss_x = F.cross_entropy(logit_x, label_x)
            out_xd = critic(F.reverse_grad(feat_x, lmda))
            out_ud = critic(F.reverse_grad(feat_u, lmda))
            loss_d = (_bce_with_logits(out_xd, torch.ones_like(out_xd))
                      + _bce_with_logits(out_ud, torch.zeros_like(out_ud)))
            self.backward_and_update((loss_x + loss_d) * s, ("model", "critic"))
        acc = (logit_x.argmax(1) == label_x).float().mean() * 100.0
        out = {"loss_x": self.global_value(loss_x * s), "acc_x": self.global_value(acc * s),
               "loss_d": self.global_value(loss_d * s)}
        out["loss"] = out["loss_x"]
        return out


@TRAINER_REGISTRY.register()
class ADDA(TrainerXU):
    """Adversarial discriminative DA (reference ``da/adda.py``): frozen
    source model; the critic and the target model update in turn; the
    target model's classifier stays frozen."""

    def check_cfg(self, cfg):
        assert check_isfile(cfg.MODEL.INIT_WEIGHTS), "The weights of source model must be provided"

    def build_model(self):
        super().build_model()
        self.copy_source_model()
        fdim = self.net.fdim
        print("Building critic network")
        self.critic = self.build_net(Critic(fdim, (fdim, fdim // 2)))
        self.register_model("critic", self.critic, self.build_optim(self.critic))

    def copy_source_model(self):
        """The frozen source model: a copy of the model as it stands."""
        self.source_net = copy.deepcopy(self.net).eval().requires_grad_(False)

    def forward_backward_xu(self, batch_x, batch_u):
        img_x, _, _ = self.parse_batch_train(batch_x)
        img_u, _, _ = self.parse_batch_train(batch_u)
        net, critic, s = self.net, self.critic, self.loss_scale
        net.train()
        critic.train()
        with self.step_scope(img_x.shape[0], img_u.shape[0]):
            with torch.no_grad():
                _, feat_x = self.source_net(img_x, return_feature=True)
            _, feat_u = net(img_u, return_feature=True)
            # the critic on the source features and the detached target ones
            logit_xd, logit_ud = critic(feat_x), critic(feat_u.detach())
            loss_critic = (_bce_with_logits(logit_xd, torch.ones_like(logit_xd))
                           + _bce_with_logits(logit_ud, torch.zeros_like(logit_ud)))
            self.backward_and_update(loss_critic * s, "critic")
            # the model fools the updated critic
            logit_ud = critic(feat_u)
            loss_model = _bce_with_logits(logit_ud, torch.ones_like(logit_ud))
            self.backward_and_update(loss_model * s, "model")
        out = {"loss_critic": self.global_value(loss_critic * s),
               "loss_model": self.global_value(loss_model * s)}
        out["loss"] = out["loss_model"]
        return out


@TRAINER_REGISTRY.register()
class AdaBN(TrainerXU):
    """Adaptive BN (reference ``da/adabn.py``): reset the source model's BN
    running statistics once, then re-estimate them with target-domain
    forwards; no parameter moves."""

    def check_cfg(self, cfg):
        assert check_isfile(cfg.MODEL.INIT_WEIGHTS), "The weights of source model must be provided"

    def build_model(self):
        super().build_model()
        self.done_reset_bn_stats = False

    @torch.no_grad()
    def before_epoch(self):
        super().before_epoch()
        if not self.done_reset_bn_stats:
            # zero means and unit variances for every BN statistic
            for leaf in dassl_leaves(self.net):
                if leaf.collection == "batch_stats" and leaf.path[-1] == "mean":
                    leaf.tensor.zero_()
                elif leaf.collection == "batch_stats" and leaf.path[-1] == "var":
                    leaf.tensor.fill_(1.0)
            self.done_reset_bn_stats = True

    @torch.no_grad()
    def forward_backward_xu(self, batch_x, batch_u):
        img_u, _, _ = self.parse_batch_train(batch_u)
        self.net.train()
        with self.step_scope(img_u.shape[0]):
            self.net(img_u)
        return None


@TRAINER_REGISTRY.register()
class MCD(_SeparateModels):
    """Maximum classifier discrepancy (reference ``da/mcd.py``): shared
    feature extractor F, twin classifiers C1/C2, three alternating updates a
    batch."""

    def build_model(self):
        self.build_f()
        for name in ("C1", "C2"):
            self.add_model(name, LinearHead(self.net.fdim, self.num_classes))
        self.lr_table = lr_schedule_from_cfg(self.cfg.OPTIM)

    def forward_backward_xu(self, batch_x, batch_u):
        img_x, label_x, _ = self.parse_batch_train(batch_x)
        img_u, _, _ = self.parse_batch_train(batch_u)
        netF, c1, c2, s = self.net, self._nets["C1"], self._nets["C2"], self.loss_scale
        n_step_f = int(self.cfg.TRAINER.MCD.N_STEP_F)

        def discrepancy(feat):
            return (torch.softmax(c1(feat), 1) - torch.softmax(c2(feat), 1)).abs().mean()

        netF.train()
        with self.step_scope(img_x.shape[0], img_u.shape[0]):
            # A: F, C1 and C2 on the source loss
            feat_x = netF(img_x)
            loss_a = F.cross_entropy(c1(feat_x), label_x) + F.cross_entropy(c2(feat_x), label_x)
            self.backward_and_update(loss_a * s, ("F", "C1", "C2"))
            # B: C1 and C2 keep the source right and maximise the target
            # discrepancy (F's no-grad forwards still update its statistics)
            with torch.no_grad():
                feat_x = netF(img_x)
                feat_u = netF(img_u)
            loss_b = (F.cross_entropy(c1(feat_x), label_x) + F.cross_entropy(c2(feat_x), label_x)
                      - discrepancy(feat_u))
            self.backward_and_update(loss_b * s, ("C1", "C2"))
            # C: F minimises it
            loss_c = torch.zeros(())
            for _ in range(n_step_f):
                loss_c = discrepancy(netF(img_u))
                self.backward_and_update(loss_c * s, "F")
        out = {"loss_step_A": self.global_value(loss_a * s),
               "loss_step_B": self.global_value(loss_b * s),
               "loss_step_C": self.global_value(loss_c * s)}
        out["loss"] = out["loss_step_A"]
        return out

    def model_inference(self, batch, scale_no=0):
        return self.infer(self.eval_images(batch), self._nets["C1"])


@TRAINER_REGISTRY.register()
class MME(_SeparateModels):
    """Minimax entropy (reference ``da/mme.py``): cosine-prototype
    classifier; the supervised update, then the adversarial entropy update
    through the GRL."""

    def build_model(self):
        self.build_f()
        self.C = self.add_model("C", Prototypes(self.net.fdim, self.num_classes))
        self.lr_table = lr_schedule_from_cfg(self.cfg.OPTIM)

    def forward_backward_xu(self, batch_x, batch_u):
        img_x, label_x, _ = self.parse_batch_train(batch_x)
        img_u, _, _ = self.parse_batch_train(batch_u)
        netF, protC, s = self.net, self.C, self.loss_scale
        lmda = float(self.cfg.TRAINER.MME.LMDA)
        netF.train()
        with self.step_scope(img_x.shape[0], img_u.shape[0]):
            logit_x = protC(netF(img_x))
            loss_x = F.cross_entropy(logit_x, label_x)
            self.backward_and_update(loss_x * s, ("F", "C"))
            # the GRL sits before the prototypes' normalisation
            prob_u = torch.softmax(protC(netF(img_u), reverse=True), 1)
            loss_u = -(-prob_u * torch.log(prob_u + 1e-5)).sum(1).mean()
            self.backward_and_update(loss_u * lmda * s, ("F", "C"))
        acc = (logit_x.argmax(1) == label_x).float().mean() * 100.0
        out = {"loss_x": self.global_value(loss_x * s), "acc_x": self.global_value(acc * s),
               "loss_u": self.global_value(loss_u * s)}
        out["loss"] = out["loss_x"]
        return out

    def model_inference(self, batch, scale_no=0):
        return self.infer(self.eval_images(batch), self.C)


@TRAINER_REGISTRY.register()
class SE(TrainerXU):
    """Self-ensembling (reference ``da/se.py``): EMA teacher consistency on
    two augmented target views (K_TRANSFORMS == 2)."""

    def check_cfg(self, cfg):
        assert cfg.DATALOADER.K_TRANSFORMS == 2

    def build_model(self):
        super().build_model()
        self.copy_teacher()

    def copy_teacher(self):
        """The teacher: a copy of the student as it stands."""
        self.teacher = copy.deepcopy(self.net).requires_grad_(False)

    def forward_backward_xu(self, batch_x, batch_u):
        t_cfg, k = self.cfg.TRAINER.SE, self.cfg.DATALOADER.K_TRANSFORMS
        global_step = self.batch_idx + self.epoch * self.num_batches
        # labeled: only the first view is used; sliced batches hold whole
        # items, so the [B, k] split is exact per slice
        loc_x, loc_u = bool(batch_x.get("_local", False)), bool(batch_u.get("_local", False))
        img_x = self.rows(np.ascontiguousarray(split_views(batch_x["img"], k)[:, 0]), loc_x)
        label_x = self.rows(np.asarray(batch_x["label"], np.int64)[::k], loc_x)
        views_u = split_views(batch_u["img"], k)
        img_u1 = self.rows(np.ascontiguousarray(views_u[:, 0]), loc_u)
        img_u2 = self.rows(np.ascontiguousarray(views_u[:, 1]), loc_u)
        conf_thre = float(t_cfg.CONF_THRE)
        # the reference evaluates the rampup only without a threshold
        weight_u = 0.0 if conf_thre else F.sigmoid_rampup(global_step, int(t_cfg.RAMPUP))
        ema_alpha = min(1 - 1 / (global_step + 1), float(t_cfg.EMA_ALPHA))
        net, teacher, s = self.net, self.teacher, self.loss_scale
        net.train()
        teacher.train()
        with self.step_scope(img_x.shape[0], img_u1.shape[0]):
            with torch.no_grad():
                t_prob_u = torch.softmax(teacher(img_u2), 1)
            logit_x = net(img_x)
            loss_x = F.cross_entropy(logit_x, label_x)
            prob_u = torch.softmax(net(img_u1), 1)
            per = ((prob_u - t_prob_u) ** 2).sum(1)
            if conf_thre:
                loss_u = (per * (t_prob_u.max(1).values > conf_thre).float()).mean()
            else:
                loss_u = per.mean() * weight_u
            self.backward_and_update((loss_x + loss_u) * s, "model")
        with torch.no_grad():
            F.ema_update(teacher, net, ema_alpha)
        acc = (logit_x.argmax(1) == label_x).float().mean() * 100.0
        out = {"loss_x": self.global_value(loss_x * s), "acc_x": self.global_value(acc * s),
               "loss_u": self.global_value(loss_u * s)}
        out["loss"] = out["loss_x"]
        return out


class _PairClassifiers(nn.Module):
    """M3SDA's two banks of per-domain classifiers, ``c1`` and ``c2``."""

    def __init__(self, n_source: int, fdim: int, num_classes: int):
        super().__init__()
        self.c1 = StackedLinears(n_source, fdim, num_classes)
        self.c2 = StackedLinears(n_source, fdim, num_classes)

    def forward(self, i, x):
        return self.c1(i, x), self.c2(i, x)


def _domain_groups(cfg, num_source_domains):
    n_domain = cfg.DATALOADER.TRAIN_X.N_DOMAIN
    if n_domain <= 0:
        n_domain = num_source_domains
    return n_domain, cfg.DATALOADER.TRAIN_X.BATCH_SIZE // n_domain


@TRAINER_REGISTRY.register()
class M3SDA(_SeparateModels):
    """Moment matching for multi-source DA (reference ``da/m3sda.py``):
    per-domain pair classifiers + first/second-moment alignment, with the
    MCD-style three-phase update."""

    def check_cfg(self, cfg):
        assert cfg.DATALOADER.TRAIN_X.SAMPLER == "RandomDomainSampler"
        assert not cfg.DATALOADER.TRAIN_U.SAME_AS_X

    def build_model(self):
        self.n_domain, self.split_batch = _domain_groups(self.cfg, self.num_source_domains)
        self.build_f()
        self.C = self.add_model("C", _PairClassifiers(self.num_source_domains, self.net.fdim,
                                                      self.num_classes))
        self.lr_table = lr_schedule_from_cfg(self.cfg.OPTIM)

    def forward_backward_xu(self, batch_x, batch_u):
        img_x, label_x, domain_x = self.parse_batch_train(batch_x)
        img_u, _, _ = self.parse_batch_train(batch_u)
        n, split = self.n_domain, self.split_batch
        imgs = self.domain_groups(img_x, n, split)
        labels = [y for y, _ in self.domain_groups(label_x, n, split)]
        # a group's domain id from any of its rows of the whole batch
        # (RandomDomainSampler groups the rows [n_domain, split])
        doms = self.gather_rows(domain_x).reshape(n, -1)[:, 0]
        t = self.cfg.TRAINER.M3SDA
        lmda, n_step_f = float(t.LMDA), int(t.N_STEP_F)
        netF, pair, s = self.net, self.C, self.loss_scale

        def moment_distance(feats, feat_u):
            # the moments of every rank's rows: each rank computes them
            # whole, its share loss_scale of them
            feats = self.gather_rows(torch.cat(feats))
            feats = feats.reshape((n, -1) + feats.shape[1:])
            feat_u = self.gather_rows(feat_u)

            def pairwise(vs, u):
                dist = sum((vs[i] - u).pow(2).sum().sqrt() for i in range(n))
                count = n
                for i in range(n - 1):
                    for j in range(i + 1, n):
                        dist = dist + (vs[i] - vs[j]).pow(2).sum().sqrt()
                        count += 1
                return dist / count

            d1 = pairwise(feats.mean(1), feat_u.mean(0))
            d2 = pairwise(feats.var(1), feat_u.var(0))  # unbiased, as torch's default
            return (d1 + d2) / 2 * s

        def ce_pair(feats):
            loss = 0.0
            for g in range(n):
                z1, z2 = pair(doms[g], feats[g])
                loss = loss + (F.cross_entropy(z1, labels[g], reduction="sum")
                               + F.cross_entropy(z2, labels[g], reduction="sum")) / split
            return loss / n

        def dis_pair(feat_u):
            loss = 0.0
            for g in range(n):
                z1, z2 = pair(doms[g], feat_u)
                loss = loss + (torch.softmax(z1, 1) - torch.softmax(z2, 1)).abs().mean()
            return loss / n * s

        netF.train()
        with self.step_scope(split, img_u.shape[0]):
            # A: F once per source domain (each sub-batch normalised by its
            # own statistics), then the target batch
            feats = self.forward_groups(netF, imgs, split)
            feat_u = netF(img_u)
            loss_a = ce_pair(feats) + moment_distance(feats, feat_u) * lmda
            self.backward_and_update(loss_a, ("F", "C"))
            # B: the classifiers maximise the target discrepancy (no-grad
            # forwards: the target first, then each domain)
            with torch.no_grad():
                feat_u = netF(img_u)
                feats = self.forward_groups(netF, imgs, split)
            loss_b = ce_pair(feats) - dis_pair(feat_u)
            self.backward_and_update(loss_b, "C")
            # C: F minimises it
            loss_c = torch.zeros((), device=img_u.device)
            for _ in range(n_step_f):
                loss_c = dis_pair(netF(img_u))
                self.backward_and_update(loss_c, "F")
        loss_a, loss_b, loss_c = self.global_sums(loss_a, loss_b, loss_c)
        return {"loss_step_A": loss_a, "loss_step_B": loss_b, "loss_step_C": loss_c,
                "loss": loss_a}

    @torch.no_grad()
    def model_inference(self, batch, scale_no=0):
        n_src = self.num_source_domains
        return self.infer(self.eval_images(batch), lambda f: sum(
            torch.softmax(self.C.c1(k, f), 1) for k in range(n_src)) / n_src)


@TRAINER_REGISTRY.register()
class DAEL(_SeparateModels):
    """Domain-adaptive ensemble learning (reference ``da/dael.py``):
    per-source-domain experts over a shared extractor; weak/strong view
    consistency + most-confident-expert pseudo-labels on the target."""

    def check_cfg(self, cfg):
        assert cfg.DATALOADER.TRAIN_X.SAMPLER == "RandomDomainSampler"
        assert not cfg.DATALOADER.TRAIN_U.SAME_AS_X
        assert len(cfg.TRAINER.DAEL.STRONG_TRANSFORMS) > 0

    def build_data_manager(self):
        cfg = self.cfg
        tfm_strong = build_transform(cfg, is_train=True, choices=cfg.TRAINER.DAEL.STRONG_TRANSFORMS)
        return DataManager(cfg, tfm_train_strong=tfm_strong,
                           allow_local_batches=type(self).SUPPORTS_LOCAL_BATCHES)

    def build_model(self):
        self.n_domain, self.split_batch = _domain_groups(self.cfg, self.num_source_domains)
        self.build_f()
        self.E = self.add_model("E", StackedLinears(self.num_source_domains, self.net.fdim,
                                                    self.num_classes, softmax=True))
        self.lr_table = lr_schedule_from_cfg(self.cfg.OPTIM)

    def forward_backward_xu(self, batch_x, batch_u):
        t = self.cfg.TRAINER.DAEL
        conf_thre, weight_u = float(t.CONF_THRE), float(t.WEIGHT_U)
        n, split, n_src = self.n_domain, self.split_batch, self.num_source_domains
        imgs = self.domain_groups(self.batch_rows(batch_x, "img"), n, split)
        imgs2 = self.domain_groups(self.batch_rows(batch_x, "img2"), n, split)
        label = self.batch_rows(batch_x, "label", np.int64)
        labels = [F.create_onehot(y, self.num_classes) for y, _ in self.domain_groups(label, n, split)]
        # a group's domain id from any of its rows of the whole batch
        doms = self.gather_rows(self.batch_rows(batch_x, "domain", np.int64)).reshape(n, -1)[:, 0]
        img_u = self.batch_rows(batch_u, "img")
        img_u2 = self.batch_rows(batch_u, "img2")
        netF, expert = self.net, self.E
        netF.train()
        with self.step_scope(split, img_u.shape[0]):
            # pseudo-labels from the most confident expert, row by row; the
            # forward advances F's statistics, which the update's forwards
            # start from
            with torch.no_grad():
                feat_u0 = netF(img_u)
                pred_u = torch.stack([expert(k, feat_u0) for k in range(n_src)])  # [K, B, C]
                experts_max_p = pred_u.max(2).values
                experts_max_idx = pred_u.argmax(2)
                max_expert_idx = experts_max_p.argmax(0)
                pseudo = experts_max_idx[max_expert_idx, torch.arange(pred_u.shape[1],
                                                                      device=img_u.device)]
                pseudo_1h = F.create_onehot(pseudo, self.num_classes).to(img_u.device)
                mask_u = (experts_max_p.max(0).values >= conf_thre).float()
            # the reference's order: every weak source view, every strong
            # one, then the strong target view
            feats = self.forward_groups(netF, imgs, split)
            feats2 = self.forward_groups(netF, imgs2, split)
            feat_u2 = netF(img_u2)
            loss_x, loss_cr, acc = expert_losses(expert, doms, feats, feats2, labels, split)
            pred_u2 = torch.stack([expert(k, feat_u2) for k in range(n_src)]).mean(0)
            loss_u = ((-pseudo_1h * torch.log(pred_u2 + 1e-5)).sum(1) * mask_u).mean()
            loss_u = loss_u * self.loss_scale
            self.backward_and_update(loss_x + loss_cr + loss_u * weight_u, ("F", "E"))
        loss_x, acc, loss_cr, loss_u = self.global_sums(loss_x, acc, loss_cr, loss_u)
        return {"loss_x": loss_x, "acc_x": acc, "loss_cr": loss_cr, "loss_u": loss_u,
                "loss": loss_x}

    @torch.no_grad()
    def model_inference(self, batch, scale_no=0):
        n_src = self.num_source_domains
        return self.infer(self.eval_images(batch), lambda f: torch.stack(
            [self.E(k, f) for k in range(n_src)]).mean(0))


@TRAINER_REGISTRY.register()
class CDAC(_SeparateModels):
    """Cross-domain adaptive clustering (reference ``da/cdac.py``):
    adversarial pairwise clustering + pseudo-labels + strong-view
    consistency, with the paper's per-iteration lr annealing."""

    def check_cfg(self, cfg):
        assert len(cfg.TRAINER.CDAC.STRONG_TRANSFORMS) > 0, (
            "Strong augmentations are necessary to run CDAC")
        assert cfg.DATALOADER.K_TRANSFORMS == 2, (
            "CDAC needs two strong augmentations of the same image.")

    def build_data_manager(self):
        cfg = self.cfg
        tfm_strong = build_transform(cfg, is_train=True, choices=cfg.TRAINER.CDAC.STRONG_TRANSFORMS)
        return DataManager(cfg, tfm_train_strong=tfm_strong,
                           allow_local_batches=type(self).SUPPORTS_LOCAL_BATCHES)

    def build_model(self):
        self.build_f()
        self.C = self.add_model("C", Prototypes(self.net.fdim, self.num_classes))
        # the lr follows the per-iteration annealing, not the epoch table
        # (reference custom_scheduler)
        self.lr_table = [self.cfg.OPTIM.LR] * self.cfg.OPTIM.MAX_EPOCH

    def before_epoch(self):
        pass  # the lr is set every iteration (forward_backward_xu)

    @staticmethod
    def _anneal(iter_, max_iter, alpha=10, beta=0.75):
        return (1 + (iter_ / max_iter) * alpha) ** (-beta)

    def forward_backward_xu(self, batch_x, batch_u):
        cfg = self.cfg
        t, k = cfg.TRAINER.CDAC, cfg.DATALOADER.K_TRANSFORMS
        current_itr = self.epoch * self.num_batches + self.batch_idx
        factor = self._anneal(current_itr, self.max_epoch * self.num_batches)
        set_lr(self._optims["F"], cfg.OPTIM.LR * factor)
        set_lr(self._optims["C"], cfg.OPTIM.LR * float(t.CLASS_LR_MULTI) * factor)
        # sliced batches hold whole items: the [B, k] splits are exact
        loc_x, loc_u = bool(batch_x.get("_local", False)), bool(batch_u.get("_local", False))
        img_x = self.rows(np.ascontiguousarray(split_views(batch_x["img"], k)[:, 0]), loc_x)
        label_x = self.rows(np.asarray(batch_x["label"], np.int64)[::k], loc_x)
        img_u = self.rows(np.ascontiguousarray(split_views(batch_u["img"], k)[:, 0]), loc_u)
        strong = split_views(batch_u["img2"], k)
        img_us = self.rows(np.ascontiguousarray(strong[:, 0]), loc_u)
        img_us2 = self.rows(np.ascontiguousarray(strong[:, 1]), loc_u)
        label_u = self.rows(np.asarray(batch_u["label"], np.int64)[::k], loc_u)
        cons_multi = F.sigmoid_rampup(current_itr, int(t.RAMPUP_ITRS)) * float(t.RAMPUP_COEF)
        topk, p_thresh = int(t.TOPK_MATCH), float(t.P_THRESH)
        netF, protC, s = self.net, self.C, self.loss_scale
        netF.train()
        with self.step_scope(img_x.shape[0], img_u.shape[0]):
            # supervised update
            logit_x = protC(netF(img_x))
            loss_x = F.cross_entropy(logit_x, label_x) * s
            self.backward_and_update(loss_x, ("F", "C"))
            # unsupervised update
            feat_u, feat_us, feat_us2 = netF(img_u), netF(img_us), netF(img_us2)
            prob_u_r = torch.softmax(protC(feat_u, reverse=True), 1)
            prob_us_r = torch.softmax(protC(feat_us, reverse=True), 1)
            # rows match when their top-k feature-index sets are equal (a
            # stable sort, reversed: ties order as in the JAX step); the
            # pairs are this rank's rows against every rank's (their sets,
            # and their probabilities with the gradient)
            order = torch.argsort(feat_u.detach(), dim=1, stable=True).flip(1)[:, :topk]
            top = torch.sort(order, dim=1).values
            sim_mat = (top[:, None, :] == self.gather_rows(top)[None, :, :]).all(-1).float()
            p = prob_u_r @ self.gather_rows(prob_us_r).T
            aac_loss = (sim_mat * torch.log(p + 1e-7)
                        + (1.0 - sim_mat) * torch.log(1.0 - p + 1e-7)).mean() * s
            prob_u = torch.softmax(protC(feat_u), 1).detach()
            logit_us2 = protC(feat_us2)
            prob_us = torch.softmax(protC(feat_us), 1)
            prob_us2 = torch.softmax(logit_us2, 1)
            max_probs, max_idx = prob_u.max(1).values, prob_u.argmax(1)
            mask = (max_probs >= p_thresh).float()
            pl_loss = (F.cross_entropy(logit_us2, max_idx, reduction="none") * mask).mean() * s
            cons_loss = cons_multi * ((prob_us - prob_us2) ** 2).mean() * s
            loss_u = aac_loss + pl_loss + cons_loss
            self.backward_and_update(loss_u, ("F", "C"))
        # the pseudo-labels' quality, counted over every rank's rows
        hit = (max_idx == label_u).float()
        acc = (logit_x.argmax(1) == label_x).float().mean() * 100.0 * s
        loss_x, acc, loss_u, aac_loss, pl_loss, cons_loss, hits_kept, n_kept, hits, n_u = (
            self.global_sums(loss_x, acc, loss_u, aac_loss, pl_loss, cons_loss, (hit * mask).sum(),
                             mask.sum(), hit.sum(), hit.new_tensor(float(hit.numel()))))
        return {"loss_x": loss_x, "acc_x": acc, "loss_u": loss_u, "aac_loss": aac_loss,
                "pl_loss": pl_loss, "cons_loss": cons_loss,
                "p_u_pred_acc_thre": hits_kept / (n_kept + 1e-5),
                "p_u_pred_acc": hits / n_u, "p_u_pred_keep": n_kept / n_u, "loss": loss_x}

    def model_inference(self, batch, scale_no=0):
        return self.infer(self.eval_images(batch), self.C)
