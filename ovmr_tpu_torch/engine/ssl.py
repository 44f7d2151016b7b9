"""Semi-supervised trainers (reference ``dassl/engine/ssl/``): SupBaseline,
EntMin, MeanTeacher, MixMatch, FixMatch.

Counterpart of ``ovmr_tpu/engine/ssl.py``, with the JAX steps' order of
forwards; a train-mode forward updates its BatchNorm's running statistics
where it runs, under ``torch.no_grad`` too, as the reference's does, so the
statistics each forward starts from are those the JAX step threads into it.

- EntMin: CE on the labeled batch plus ``ENTMIN.LMDA`` times the entropy of
  the unlabeled predictions, one backward.
- MeanTeacher: a teacher copy of the student, run in train mode (its BN
  statistics from its own forwards; only its parameters are EMA'd), its
  softmax the target of the student's; the consistency weight ramps with
  the epoch, the EMA decay with the global step.
- MixMatch: K no-grad train-mode guesses (each advances the statistics),
  sharpened; the labeled and unlabeled rows shuffled together and mixed
  with per-row coefficients. The permutation and the coefficients are drawn
  on the host from the step's seed (:meth:`MixMatch.mixup_draws`), so the
  card and the CPU draw the same ones and a caller can inject its own. They
  span the whole batch: under a process group every rank builds the whole
  joint batch from every rank's rows (the images and the guesses gathered)
  and forwards its own block of the mixed rows.
- FixMatch: confident pseudo-labels from a no-grad weak forward over
  ``cat(x, u)`` supervise the strong views ``cat(x2, u2)``; the strong views
  come from ``tfm_train_strong`` as ``img2`` (keyed on the global stream
  position, so a rank's sliced rows are those of a full decode).

Every step returns ``loss = loss_x`` as the NaN guard's headline.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ovmr_tpu_torch.data.manager import DataManager
from ovmr_tpu_torch.data.transforms import build_transform
from ovmr_tpu_torch.engine.dassl_base import DasslTrainer, TrainerXU, split_views
from ovmr_tpu_torch.engine.trainer import TRAINER_REGISTRY
from ovmr_tpu_torch.modeling import ops as F


@TRAINER_REGISTRY.register()
class SupBaseline(TrainerXU):
    """Supervised baseline: the labeled batch only (reference
    ``ssl/sup_baseline.py``)."""

    def forward_backward_xu(self, batch_x, batch_u):
        return DasslTrainer.forward_backward(self, batch_x)


@TRAINER_REGISTRY.register()
class EntMin(TrainerXU):
    """Entropy minimisation on the unlabeled batch (reference
    ``ssl/entmin.py``; Grandvalet & Bengio, NeurIPS'04)."""

    def forward_backward_xu(self, batch_x, batch_u):
        img_x, label_x, _ = self.parse_batch_train(batch_x)
        img_u, _, _ = self.parse_batch_train(batch_u)
        lmda = float(self.cfg.TRAINER.ENTMIN.LMDA)
        net, s = self.net, self.loss_scale
        net.train()
        with self.step_scope(img_x.shape[0], img_u.shape[0]):
            out_x = net(img_x)
            loss_x = F.cross_entropy(out_x, label_x)
            p_u = torch.softmax(net(img_u), 1)
            loss_u = (-p_u * torch.log(p_u + 1e-5)).sum(1).mean()
            self.backward_and_update((loss_x + loss_u * lmda) * s, "model")
        acc = (out_x.argmax(1) == label_x).float().mean() * 100.0
        out = {"loss_x": self.global_value(loss_x * s), "acc_x": self.global_value(acc * s),
               "loss_u": self.global_value(loss_u * s)}
        out["loss"] = out["loss_x"]
        return out


@TRAINER_REGISTRY.register()
class MeanTeacher(TrainerXU):
    """Mean-teacher consistency (reference ``ssl/mean_teacher.py``): student
    CE + the squared distance to an EMA teacher's softmax, the teacher in
    train mode."""

    def build_model(self):
        super().build_model()
        self.copy_teacher()

    def copy_teacher(self):
        """The teacher: a copy of the student as it stands."""
        self.teacher = copy.deepcopy(self.net).requires_grad_(False)

    def forward_backward_xu(self, batch_x, batch_u):
        t_cfg = self.cfg.TRAINER.MEANTEACHER
        img_x, label_x, _ = self.parse_batch_train(batch_x)
        img_u, _, _ = self.parse_batch_train(batch_u)
        weight_u = float(t_cfg.WEIGHT_U) * F.sigmoid_rampup(self.epoch, int(t_cfg.RAMPUP))
        global_step = self.batch_idx + self.epoch * self.num_batches
        ema_alpha = min(1 - 1 / (global_step + 1), float(t_cfg.EMA_ALPHA))
        net, teacher, s = self.net, self.teacher, self.loss_scale
        net.train()
        teacher.train()
        with self.step_scope(img_x.shape[0], img_u.shape[0]):
            with torch.no_grad():
                target_u = torch.softmax(teacher(img_u), 1)
            logit_x = net(img_x)
            loss_x = F.cross_entropy(logit_x, label_x)
            prob_u = torch.softmax(net(img_u), 1)
            loss_u = ((prob_u - target_u) ** 2).sum(1).mean()
            self.backward_and_update((loss_x + loss_u * weight_u) * s, "model")
        F.ema_update(teacher, net, ema_alpha)  # parameters only
        acc = (logit_x.argmax(1) == label_x).float().mean() * 100.0
        out = {"loss_x": self.global_value(loss_x * s), "acc_x": self.global_value(acc * s),
               "loss_u": self.global_value(loss_u * s)}
        out["loss"] = out["loss_x"]
        return out


@TRAINER_REGISTRY.register()
class MixMatch(TrainerXU):
    """MixMatch (reference ``ssl/mixmatch.py``): K-augmented pseudo-label
    guessing, sharpening, shuffled mixup of the joint batch."""

    def check_cfg(self, cfg):
        assert cfg.DATALOADER.K_TRANSFORMS > 1

    def mixup_draws(self, gen: torch.Generator, n_x: int, n_u: int):
        """The step's shuffle of the ``n_x + n_u`` joint rows and the
        coefficients of the labeled and the unlabeled mixup (``max(lam,
        1 - lam)`` of Beta(MIXUP_BETA, MIXUP_BETA) draws), from a host
        generator seeded with the step's seed."""
        rng = np.random.default_rng(gen.initial_seed())
        beta = float(self.cfg.TRAINER.MIXMATCH.MIXUP_BETA)
        perm = rng.permutation(n_x + n_u)
        lam_x = rng.beta(beta, beta, n_x)
        lam_u = rng.beta(beta, beta, n_u)
        return (perm, np.maximum(lam_x, 1.0 - lam_x).astype(np.float32),
                np.maximum(lam_u, 1.0 - lam_u).astype(np.float32))

    def forward_backward_xu(self, batch_x, batch_u):
        t_cfg, k = self.cfg.TRAINER.MIXMATCH, self.cfg.DATALOADER.K_TRANSFORMS
        temp, beta = float(t_cfg.TEMP), float(t_cfg.MIXUP_BETA)
        loc_x, loc_u = bool(batch_x.get("_local", False)), bool(batch_u.get("_local", False))
        # labeled: the first view only (reference batch_x["img"][0])
        img_x = self.rows(np.ascontiguousarray(split_views(batch_x["img"], k)[:, 0]), loc_x)
        label_x = self.rows(np.asarray(batch_x["label"], np.int64)[::k], loc_x)
        views_u = split_views(batch_u["img"], k)
        imgs_u = [self.rows(np.ascontiguousarray(views_u[:, v]), loc_u) for v in range(k)]
        global_step = self.batch_idx + self.epoch * self.num_batches
        weight_u = float(t_cfg.WEIGHT_U) * F.linear_rampup(global_step, int(t_cfg.RAMPUP))
        net, n_cls, s = self.net, self.num_classes, self.loss_scale
        net.train()
        with self.step_scope(img_x.shape[0], imgs_u[0].shape[0], k * imgs_u[0].shape[0]) as gen:
            # the joint batch of every rank's rows: [x; u view 0; u view 1; ...]
            all_x = self.gather_rows(img_x)
            input_u = torch.cat([self.gather_rows(img) for img in imgs_u])  # view by view
            n_x, n_u = all_x.shape[0], input_u.shape[0]
            perm, lam_x, lam_u = self.mixup_draws(gen, n_x, n_u)
            # the guesses: K train-mode forwards of this rank's rows without
            # gradients, each advancing the BN statistics the update's
            # forwards start from
            with torch.no_grad():
                p_sum = sum(torch.softmax(net(img), 1) for img in imgs_u)
                label_u = self.gather_rows(F.sharpen_prob(p_sum / k, temp))
            label_u_rep = label_u.repeat(k, 1)
            label_x_1h = F.create_onehot(self.gather_rows(label_x), n_cls).to(img_x.device)
            perm = torch.as_tensor(np.asarray(perm), device=img_x.device)
            input_xu = torch.cat([all_x, input_u])[perm]
            label_xu = torch.cat([label_x_1h, label_u_rep])[perm]
            mixed_x, mlabel_x = F.mixup(all_x, input_xu[:n_x], label_x_1h, label_xu[:n_x], beta,
                                        preserve_order=True, lam=lam_x)
            mixed_u, mlabel_u = F.mixup(input_u, input_xu[n_x:], label_u_rep, label_xu[n_x:],
                                        beta, preserve_order=True, lam=lam_u)
            # this rank's block of the mixed rows
            p_x = torch.softmax(net(self.own_rows(mixed_x)), 1)
            loss_x = (-self.own_rows(mlabel_x) * torch.log(p_x + 1e-5)).sum(1).mean() * s
            p_u = torch.softmax(net(self.own_rows(mixed_u)), 1)
            loss_u = ((self.own_rows(mlabel_u) - p_u) ** 2).mean() * s
            self.backward_and_update(loss_x + loss_u * weight_u, "model")
        loss_x, loss_u = self.global_sums(loss_x, loss_u)
        return {"loss_x": loss_x, "loss_u": loss_u, "loss": loss_x}


@TRAINER_REGISTRY.register()
class FixMatch(TrainerXU):
    """FixMatch (reference ``ssl/fixmatch.py``): confident pseudo-labels
    from the weak view supervise the strong view; the labeled batch joins
    the unlabeled passes, as in the reference."""

    def check_cfg(self, cfg):
        assert len(cfg.TRAINER.FIXMATCH.STRONG_TRANSFORMS) > 0

    def build_data_manager(self):
        cfg = self.cfg
        tfm_strong = build_transform(cfg, is_train=True,
                                     choices=cfg.TRAINER.FIXMATCH.STRONG_TRANSFORMS)
        return DataManager(cfg, tfm_train_strong=tfm_strong,
                           allow_local_batches=type(self).SUPPORTS_LOCAL_BATCHES)

    def forward_backward_xu(self, batch_x, batch_u):
        t_cfg = self.cfg.TRAINER.FIXMATCH
        conf_thre, weight_u = float(t_cfg.CONF_THRE), float(t_cfg.WEIGHT_U)
        img_x, img_x2 = self.batch_rows(batch_x, "img"), self.batch_rows(batch_x, "img2")
        label_x = self.batch_rows(batch_x, "label", np.int64)
        img_u, img_u2 = self.batch_rows(batch_u, "img"), self.batch_rows(batch_u, "img2")
        label_u = self.batch_rows(batch_u, "label", np.int64)
        n_x, n_xu = img_x.shape[0], img_x.shape[0] + img_u.shape[0]
        net, s = self.net, self.loss_scale
        net.train()
        with self.step_scope(n_xu, n_x, n_xu):
            # pseudo-labels from the weak views (a no-grad train forward that
            # still advances the BN statistics)
            with torch.no_grad():
                prob_w = torch.softmax(net(torch.cat([img_x, img_u])), 1)
                max_prob, label_u_pred = prob_w.max(1)
                mask_u = (max_prob >= conf_thre).float()
            out_x = net(img_x)
            loss_x = F.cross_entropy(out_x, label_x)
            out_u = net(torch.cat([img_x2, img_u2]))
            loss_u = (F.cross_entropy(out_u, label_u_pred, reduction="none") * mask_u).mean()
            self.backward_and_update((loss_x + loss_u * weight_u) * s, "model")
        # the pseudo-labels' quality over the unlabeled rows (reference
        # assess_y_pred_quality), summed over the data axis' ranks
        hit = (label_u_pred[n_x:] == label_u).float()
        kept = mask_u[n_x:]
        acc = (out_x.argmax(1) == label_x).float().mean() * 100.0
        loss_x, acc, loss_u, hits_kept, n_kept, hits, n_u = self.global_sums(
            loss_x * s, acc * s, loss_u * s, (hit * kept).sum(), kept.sum(), hit.sum(),
            hit.new_tensor(float(hit.numel())))
        return {"loss_x": loss_x, "acc_x": acc, "loss_u": loss_u,
                "y_u_pred_acc_raw": hits / n_u, "y_u_pred_acc_thre": hits_kept / (n_kept + 1e-5),
                "y_u_pred_keep": n_kept / n_u, "loss": loss_x}
