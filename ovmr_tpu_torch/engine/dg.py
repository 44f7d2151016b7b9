"""Domain-generalization trainers (reference ``dassl/engine/dg/``):
Vanilla, CrossGrad, DDAIG, DAELDG, DomainMix.

Counterpart of ``ovmr_tpu/engine/dg.py``, with the JAX steps' order of
forwards and updates: a train-mode forward updates its BatchNorm's running
statistics where it runs, so the statistics a later phase of the step
starts from are those the JAX step threads into it. CrossGrad takes its
input gradients with ``torch.autograd.grad`` on a leaf copy of the batch;
DDAIG updates G from ``CE(F(G(x))) - CE(D(G(x)))`` with F and D in train
mode, perturbs again with the updated G, then updates F (blending in the
perturbed batch after ``WARMUP``) and D; DomainMix draws its cross-domain
permutation on the host from ``default_rng(SEED)``, as the JAX trainer.
"""

from __future__ import annotations

import numpy as np
import torch

from ovmr_tpu_torch.data.manager import DataManager
from ovmr_tpu_torch.data.transforms import build_transform
from ovmr_tpu_torch.engine.dassl_base import (
    StackedLinears,
    TrainerX,
    build_simplenet,
    expert_losses,
)
from ovmr_tpu_torch.engine.schedule import lr_schedule_from_cfg
from ovmr_tpu_torch.engine.trainer import TRAINER_REGISTRY
from ovmr_tpu_torch.modeling import build_network
from ovmr_tpu_torch.modeling import ops as F
from ovmr_tpu_torch.models.resnet import exact_fp32_convolutions


@TRAINER_REGISTRY.register()
class Vanilla(TrainerX):
    """Empirical risk minimization (reference ``dg/vanilla.py``): the
    supervised step of :class:`DasslTrainer`."""


class _FDTrainer(TrainerX):
    """The label net F and the domain net D of CrossGrad and DDAIG."""

    def build_fd(self):
        cfg = self.cfg
        print("Building F")
        self.netF = self.build_net(build_simplenet(cfg, cfg.MODEL, self.num_classes))
        self.register_model("F", self.netF, self.build_optim(self.netF))
        print("Building D")
        self.netD = self.build_net(build_simplenet(cfg, cfg.MODEL, self.num_source_domains))
        self.register_model("D", self.netD, self.build_optim(self.netD))


@TRAINER_REGISTRY.register()
class CrossGrad(_FDTrainer):
    """Cross-gradient training (reference ``dg/crossgrad.py``): the label and
    domain nets perturb each other's inputs with clipped input gradients."""

    def build_model(self):
        self.build_fd()
        self.lr_table = lr_schedule_from_cfg(self.cfg.OPTIM)

    def forward_backward(self, batch):
        img, label, domain = self.parse_batch_train(batch)
        t = self.cfg.TRAINER.CROSSGRAD
        eps_f, eps_d = float(t.EPS_F), float(t.EPS_D)
        alpha_f, alpha_d = float(t.ALPHA_F), float(t.ALPHA_D)
        netF, netD, s = self.netF, self.netD, self.loss_scale
        netF.train()
        netD.train()
        with self.step_scope(img.shape[0]):
            # input gradients of each net's loss (train-mode forwards: their
            # BN running statistics carry into the updates below)
            x = img.detach().requires_grad_(True)
            (grad_d,) = torch.autograd.grad(F.cross_entropy(netD(x), domain) * s, x)
            input_d = img + eps_f * grad_d.clamp(-0.1, 0.1)
            x = img.detach().requires_grad_(True)
            (grad_f,) = torch.autograd.grad(F.cross_entropy(netF(x), label) * s, x)
            input_f = img + eps_d * grad_f.clamp(-0.1, 0.1)

            # the label net on (x, x_d), then the domain net on (x, x_f)
            loss_f = ((1 - alpha_f) * F.cross_entropy(netF(img), label)
                      + alpha_f * F.cross_entropy(netF(input_d), label)) * s
            self.backward_and_update(loss_f, "F")
            loss_d = ((1 - alpha_d) * F.cross_entropy(netD(img), domain)
                      + alpha_d * F.cross_entropy(netD(input_f), domain)) * s
            self.backward_and_update(loss_d, "D")
        out = {"loss_f": self.global_value(loss_f), "loss_d": self.global_value(loss_d)}
        out["loss"] = out["loss_f"]
        return out

    # inference: DasslTrainer.model_inference on the first registered
    # model ("F"), the reference's `return self.F(input)`


@TRAINER_REGISTRY.register()
class DDAIG(_FDTrainer):
    """Deep domain-adversarial image generation (reference ``dg/ddaig.py``):
    the FCN generator perturbs inputs to fool the domain net while keeping
    the label net right."""

    def build_model(self):
        cfg = self.cfg
        self.build_fd()
        print("Building G")
        self.netG = self.build_net(build_network(cfg.TRAINER.DDAIG.G_ARCH, verbose=cfg.VERBOSE,
                                                 image_size=cfg.INPUT.SIZE[0]))
        self.register_model("G", self.netG, self.build_optim(self.netG))
        self.lr_table = lr_schedule_from_cfg(cfg.OPTIM)

    def _perturb(self, img):
        t = self.cfg.TRAINER.DDAIG
        x_p = self.netG(img, lmda=float(t.LMDA))
        if bool(t.CLAMP):
            x_p = x_p.clamp(float(t.CLAMP_MIN), float(t.CLAMP_MAX))
        return x_p

    def forward_backward(self, batch):
        img, label, domain = self.parse_batch_train(batch)
        alpha = float(self.cfg.TRAINER.DDAIG.ALPHA)
        apply_pert = (self.epoch + 1) > int(self.cfg.TRAINER.DDAIG.WARMUP)
        netF, netD, netG, s = self.netF, self.netD, self.netG, self.loss_scale
        for net in (netF, netD, netG):
            net.train()
        with self.step_scope(img.shape[0]):
            # ---- G: its F/D forwards run in train mode, and their BN
            # statistics carry into the F/D updates below
            x_p = self._perturb(img)
            loss_g = (F.cross_entropy(netF(x_p), label) - F.cross_entropy(netD(x_p), domain)) * s
            params_g = list(netG.parameters())
            grads = torch.autograd.grad(loss_g, params_g)
            optG = self._optims["G"]
            optG.zero_grad(set_to_none=True)
            for p, g in zip(params_g, grads):
                p.grad = g
            self.sync_grads(netG)
            optG.step()
            # perturb with the new generator (no gradient)
            with torch.no_grad():
                x_p = self._perturb(img)
            # ---- F: the perturbed batch only after the warmup (the
            # reference runs no perturbed forward, no BN update, before it)
            loss_f = F.cross_entropy(netF(img), label)
            if apply_pert:
                loss_f = (1 - alpha) * loss_f + alpha * F.cross_entropy(netF(x_p), label)
            self.backward_and_update(loss_f * s, "F")
            # ---- D
            loss_d = F.cross_entropy(netD(img), domain) * s
            self.backward_and_update(loss_d, "D")
        out = {"loss_g": self.global_value(loss_g), "loss_f": self.global_value(loss_f * s),
               "loss_d": self.global_value(loss_d)}
        out["loss"] = out["loss_f"]
        return out


@TRAINER_REGISTRY.register()
class DAELDG(TrainerX):
    """DAEL for DG, labeled sources only (reference ``dg/daeldg.py``):
    per-domain experts + cross-expert consistency on the strong view. Under
    a process group each rank forwards its rows of every domain group
    (:meth:`DasslTrainer.domain_groups`)."""

    def check_cfg(self, cfg):
        assert cfg.DATALOADER.TRAIN_X.SAMPLER == "RandomDomainSampler"
        assert len(cfg.TRAINER.DAELDG.STRONG_TRANSFORMS) > 0

    def build_data_manager(self):
        cfg = self.cfg
        tfm_strong = build_transform(cfg, is_train=True,
                                     choices=cfg.TRAINER.DAELDG.STRONG_TRANSFORMS)
        return DataManager(cfg, tfm_train_strong=tfm_strong,
                           allow_local_batches=type(self).SUPPORTS_LOCAL_BATCHES)

    def build_model(self):
        cfg = self.cfg
        n_domain = cfg.DATALOADER.TRAIN_X.N_DOMAIN
        if n_domain <= 0:
            n_domain = self.num_source_domains
        self.n_domain = n_domain
        self.split_batch = cfg.DATALOADER.TRAIN_X.BATCH_SIZE // n_domain

        print("Building F")
        self.net = self.build_net(build_simplenet(cfg, cfg.MODEL, 0))
        self.register_model("F", self.net, self.build_optim(self.net))
        print("Building E")
        self.E = self.build_net(StackedLinears(self.num_source_domains, self.net.fdim,
                                               self.num_classes, softmax=True))
        self.register_model("E", self.E, self.build_optim(self.E))
        self.lr_table = lr_schedule_from_cfg(cfg.OPTIM)

    def forward_backward(self, batch):
        n, split = self.n_domain, self.split_batch
        img = self.domain_groups(self.batch_rows(batch, "img"), n, split)
        img2 = self.domain_groups(self.batch_rows(batch, "img2"), n, split)
        label = self.batch_rows(batch, "label", np.int64)
        labels = [F.create_onehot(y, self.num_classes) for y, _ in self.domain_groups(label, n, split)]
        # a group's domain id from any of its rows of the whole batch
        doms = self.gather_rows(self.batch_rows(batch, "domain", np.int64)).reshape(n, -1)[:, 0]
        netF = self.net
        netF.train()
        with self.step_scope(split):
            # the reference's order: every weak view, then every strong view
            # (BN running statistics depend on it)
            feats = self.forward_groups(netF, img, split)
            feats2 = self.forward_groups(netF, img2, split)
            loss_x, loss_cr, acc = expert_losses(self.E, doms, feats, feats2, labels, split)
            self.backward_and_update(loss_x + loss_cr, ("F", "E"))
        loss_x, acc, loss_cr = self.global_sums(loss_x, acc, loss_cr)
        return {"loss_x": loss_x, "acc": acc, "loss_cr": loss_cr, "loss": loss_x}

    @torch.no_grad()
    def model_inference(self, batch, scale_no=0):
        x = self.eval_images(batch)
        self.net.eval()
        with exact_fp32_convolutions():
            f = self.net(x)
            p = torch.stack([self.E(k, f) for k in range(self.num_source_domains)])
            return p.mean(0).float().cpu().numpy()


@TRAINER_REGISTRY.register()
class DomainMix(TrainerX):
    """DomainMix (reference ``dg/domain_mix.py``): mixup across samples
    ('random') or across domains ('crossdomain'); the permutation depends on
    the data, so it is drawn on the host."""

    # the host-side mix permutes across the whole batch: every process
    # decodes it whole (no sliced loading)
    SUPPORTS_LOCAL_BATCHES = False

    def build_model(self):
        super().build_model()
        self._np_rng = np.random.default_rng(max(self.cfg.SEED, 0))

    def _domain_mix(self, x, target, domain):
        t = self.cfg.TRAINER.DOMAINMIX
        alpha, beta = float(t.ALPHA), float(t.BETA)
        lam = float(self._np_rng.beta(alpha, beta)) if alpha > 0 else 1.0
        b = x.shape[0]
        perm = self._np_rng.permutation(b)
        if t.TYPE == "crossdomain":
            domain_list = np.unique(domain)
            if len(domain_list) > 1:
                for idx in domain_list:
                    # pair each sample of domain idx with one drawn from the
                    # other domains (with replacement iff needed)
                    cnt_a = int((domain == idx).sum())
                    idx_b = np.flatnonzero(domain != idx)
                    perm_b = self._np_rng.choice(len(idx_b), size=cnt_a,
                                                 replace=bool(cnt_a > len(idx_b)))
                    perm[domain == idx] = idx_b[perm_b]
        elif t.TYPE != "random":
            raise NotImplementedError(f"Chooses {'random', 'crossdomain'}, but got {t.TYPE}.")
        mixed = lam * x + (1 - lam) * x[perm]
        return mixed, target, target[perm], lam

    def forward_backward(self, batch):
        img = np.asarray(batch["img"], np.float32)
        target = np.asarray(batch["label"])
        domain = np.asarray(batch["domain"])
        mixed, label_a, label_b, lam = self._domain_mix(img, target, domain)
        mixed = self.rows(mixed)
        label_a = self.rows(label_a.astype(np.int64))
        label_b = self.rows(label_b.astype(np.int64))
        net = self._nets["model"]
        net.train()
        with self.step_scope(mixed.shape[0]):
            out = net(mixed)
            loss = (lam * F.cross_entropy(out, label_a)
                    + (1 - lam) * F.cross_entropy(out, label_b)) * self.loss_scale
            self.backward_and_update(loss, "model")
        acc = (out.argmax(1) == label_a).float().mean() * 100.0 * self.loss_scale
        return {"loss": self.global_value(loss), "acc": self.global_value(acc)}
