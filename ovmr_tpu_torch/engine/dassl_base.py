"""Generic backbone+head trainers (reference ``dassl/engine/trainer.py``:
``SimpleNet``/``SimpleTrainer``/``TrainerX``/``TrainerXU``).

Counterpart of ``ovmr_tpu/engine/dassl_base.py``. A trainer registers its
models (:meth:`DasslTrainer.register_model`): an ``nn.Module`` on
``CUDA.DEVICE`` and the ``torch.optim`` optimizer over its parameters,
with BatchNorm statistics updated in place by the train-mode forwards, as
torch does them. The epoch loop, evaluation and checkpoint cadence are
:class:`ovmr_tpu_torch.engine.trainer.TrainerBase`'s.

- **Draws.** Where the JAX step folds one PRNG key a step, each step here
  draws from a ``torch.Generator`` seeded from ``(SEED, step)``
  (:meth:`DasslTrainer.step_generator`), through which dropout and
  MixStyle/EFDMix draw (:func:`ovmr_tpu_torch.modeling.ops.rng_scope`); a
  resumed run goes on with the next step's generator.
- **fp32.** Every step and inference runs with cuDNN's TF32 off
  (:func:`ovmr_tpu_torch.models.resnet.exact_fp32_convolutions`; cuBLAS'
  is off by torch's default), so a card computes what the CPU does up to
  summation order.
- **The data axis** (:func:`setup_dassl_mesh`): ``CUDA.MESH.DATA`` local
  shards on one process, or one shard a rank under a process group. Train
  mode BatchNorm then reduces its statistics over the axis
  (:func:`ovmr_tpu_torch.modeling.layers.data_axis_scope`), so they are the
  global batch's, as the GSPMD program of the JAX package computes them.
  Under a process group each rank steps on its block of the batch, the
  row-mean losses are divided by the axis size and the gradients summed
  over it, which gives every rank the single program's update. The
  trainers whose losses span the whole batch take what crosses the ranks
  from :meth:`DasslTrainer.gather_rows` (the data axis' all-gather, whose
  backward sums the ranks' cotangents) and their domain groups from
  :meth:`DasslTrainer.domain_groups` (a rank's block cuts across the
  groups: each group's BatchNorm statistics are those of all its rows, a
  loss over a group this rank's share of the group's sum); dropout draws
  the mask of the whole batch and keeps this rank's rows
  (:func:`ovmr_tpu_torch.modeling.ops.row_window`).
- **Checkpoints** are the JAX package's npz files
  (:mod:`ovmr_tpu_torch.engine.checkpoint`): one subdirectory a model,
  ``params//params//...`` and ``params//batch_stats//...`` in the flax
  layout (:func:`ovmr_tpu_torch.convert.dassl_leaves`) and the optimizer
  state in optax's, so either package resumes the other's run. With
  ``CUDA.CHECKPOINT_BACKEND orbax`` each model's epoch saves go through
  :mod:`ovmr_tpu_torch.engine.orbax_io` (orbax's layout, on every rank),
  the same leaves and optimizer entries; named saves stay npz.
"""

from __future__ import annotations

import contextlib
import datetime
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from ovmr_tpu_torch.convert import dassl_leaves, dassl_state_from_numpy, dassl_state_to_numpy
from ovmr_tpu_torch.data.prefetch import prefetch_batches
from ovmr_tpu_torch.engine import checkpoint as ckpt
from ovmr_tpu_torch.engine.optimizers import build_optimizer, set_lr
from ovmr_tpu_torch.engine.schedule import lr_schedule_from_cfg
from ovmr_tpu_torch.engine.trainer import TrainerBase
from ovmr_tpu_torch.modeling import build_backbone, build_head
from ovmr_tpu_torch.modeling import ops as F
from ovmr_tpu_torch.modeling.backbones import init_weights
from ovmr_tpu_torch.modeling.layers import TorchBatchNorm, data_axis_scope
from ovmr_tpu_torch.models.resnet import exact_fp32_convolutions
from ovmr_tpu_torch.utils import AverageMeter, MetricMeter


class SimpleNet(nn.Module):
    """Backbone (+ optional mlp head) (+ optional linear classifier)
    (reference ``dassl/engine/trainer.py:22-74``)."""

    def __init__(self, backbone: nn.Module, head: Optional[nn.Module], num_classes: int):
        super().__init__()
        self.backbone = backbone
        if head is not None:
            self.head = head
        self.has_head = head is not None
        self.fdim = (head or backbone).out_features
        self.num_classes = num_classes
        if num_classes > 0:
            self.classifier = init_weights(nn.Linear(self.fdim, num_classes))

    def forward(self, x, return_feature: bool = False):
        f = self.backbone(x)
        if self.has_head:
            f = self.head(f)
        if self.num_classes <= 0:
            return f
        y = self.classifier(f)
        return (y, f) if return_feature else y


def build_simplenet(cfg, model_cfg, num_classes: int, **kwargs) -> SimpleNet:
    backbone = build_backbone(model_cfg.BACKBONE.NAME, verbose=cfg.VERBOSE,
                              pretrained=model_cfg.BACKBONE.PRETRAINED, **kwargs)
    head = None
    if model_cfg.HEAD.NAME and model_cfg.HEAD.HIDDEN_LAYERS:
        head = build_head(model_cfg.HEAD.NAME, verbose=cfg.VERBOSE,
                          in_features=backbone.out_features,
                          hidden_layers=model_cfg.HEAD.HIDDEN_LAYERS,
                          activation=model_cfg.HEAD.ACTIVATION, bn=model_cfg.HEAD.BN,
                          dropout=model_cfg.HEAD.DROPOUT)
    return SimpleNet(backbone, head, num_classes)


class LinearHead(nn.Module):
    """A bare linear classifier registered as its own model (MCD's C1/C2)."""

    def __init__(self, fdim: int, num_classes: int):
        super().__init__()
        self.fc = init_weights(nn.Linear(fdim, num_classes))

    def forward(self, x):
        return self.fc(x)


class Critic(nn.Module):
    """Domain critic: mlp body + scalar logit head (reference DANN/ADDA
    ``build_critic``)."""

    def __init__(self, fdim: int, hidden):
        super().__init__()
        self.n = len(hidden)
        for i, dim in enumerate(hidden):
            self.add_module(f"fc{i}", nn.Linear(fdim, dim))
            self.add_module(f"bn{i}", TorchBatchNorm(dim))
            fdim = dim
        self.logit = nn.Linear(fdim, 1)
        init_weights(self)

    def forward(self, x):
        for i in range(self.n):
            x = torch.nn.functional.leaky_relu(getattr(self, f"bn{i}")(getattr(self, f"fc{i}")(x)),
                                               0.01)
        return self.logit(x)


class Prototypes(nn.Module):
    """Temperature-scaled cosine classifier (reference MME/CDAC
    ``Prototypes``); ``reverse`` puts the GRL before the normalisation."""

    def __init__(self, fdim: int, num_classes: int, temp: float = 0.05):
        super().__init__()
        self.temp = temp
        self.prototypes = init_weights(nn.Linear(fdim, num_classes, bias=False))

    def forward(self, x, reverse: bool = False, grad_scaling: float = 1.0):
        if reverse:
            x = F.reverse_grad(x, grad_scaling)
        # torch F.normalize: an all-zero row stays zero
        x = x / torch.linalg.norm(x, dim=1, keepdim=True).clamp_min(1e-12)
        return self.prototypes(x) / self.temp


class StackedLinears(nn.Module):
    """K per-domain linear classifiers as one ``kernel [K, fdim, C]`` and
    ``bias [K, C]`` (the JAX package's layout), an index selecting the
    expert (a tensor index stays on the device)."""

    def __init__(self, n_source: int, fdim: int, num_classes: int, softmax: bool = False):
        super().__init__()
        self.softmax = softmax
        self.kernel = nn.Parameter(torch.randn(n_source, fdim, num_classes) / fdim ** 0.5)
        self.bias = nn.Parameter(torch.zeros(n_source, num_classes))

    def forward(self, i, x):
        out = x @ self.kernel[i] + self.bias[i]
        return torch.softmax(out, dim=1) if self.softmax else out


def expert_losses(expert: StackedLinears, doms, feats, feats2, labels, split: int):
    """DAEL's losses over the domain groups (reference ``da/dael.py``,
    ``dg/daeldg.py``): each group's expert's cross entropy on the weak view,
    the squared distance of the other domains' experts' mean on the strong
    view to that expert's (detached) prediction, and the expert's accuracy.
    ``feats``, ``feats2`` and the one-hot ``labels`` are a group a list
    (:meth:`DasslTrainer.domain_groups`' pieces); a group's row sum over its
    ``split`` rows is this process's share of the group's mean. Returns
    ``(loss_x, loss_cr, acc)``, each averaged over the groups."""
    n = len(feats)
    loss_x = loss_cr = acc = 0.0
    for g in range(n):
        pred_i = expert(doms[g], feats[g])
        loss_x = loss_x + (-labels[g] * torch.log(pred_i + 1e-5)).sum(1).sum() / split
        expert_label = pred_i.detach()
        acc = acc + (pred_i.argmax(1) == labels[g].argmax(1)).float().sum() / split * 100.0
        cr = torch.zeros_like(pred_i)
        for h in range(n):
            if h != g:
                cr = cr + expert(doms[h], feats2[g])
        cr = cr / (n - 1)
        loss_cr = loss_cr + ((cr - expert_label) ** 2).sum(1).sum() / split
    return loss_x / n, loss_cr / n, acc / n


def load_init_weights(net: nn.Module, path: str) -> nn.Module:
    """Load ``MODEL.INIT_WEIGHTS`` (an npz of the JAX package's or the
    port's Dassl checkpoints: ``params//params//...`` and
    ``params//batch_stats//...``) into ``net`` (reference
    ``load_pretrained_weights``)."""
    sep = ckpt.SEP
    tree = {"params": {}, "batch_stats": {}}
    with np.load(path) as data:
        for key in data.files:
            if not key.startswith("params" + sep):
                continue
            parts = key.split(sep)[1:]
            node = tree.setdefault(parts[0], {})
            for p in parts[1:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
    dassl_state_from_numpy(net, tree)
    print(f"Loaded init weights from {path}")
    return net


def setup_dassl_mesh(cfg, label=""):
    """The data-parallel mesh of the SimpleNet trainer families (JAX
    ``setup_dassl_mesh`` :189): None on one process unless
    ``CUDA.MESH.DATA`` asks for n > 1 local shards, and with
    ``CUDA.MESH.DATA 1``; otherwise the data axis (one shard a rank under a
    process group, ``-1`` taking every rank). ``CUDA.MESH.MODEL > 1`` has no
    tensor-parallel meaning for these CNNs and only warns. ``TPU.MESH.*``
    of a JAX config reads onto ``CUDA.MESH.*``."""
    from ovmr_tpu_torch.parallel.mesh import build_mesh
    from ovmr_tpu_torch.parallel.multihost import world

    data, model = int(cfg.CUDA.MESH.DATA), int(cfg.CUDA.MESH.MODEL)
    if data == 1 or (data == -1 and world() <= 1):
        return None
    if model > 1:
        print(f"WARNING: CUDA.MESH.MODEL={model} has no tensor-parallel meaning for "
              "SimpleNet backbones; using the data axis only")
    mesh = build_mesh(data if data > 0 else world(), 1)
    print(f"{label}data-parallel mesh: {mesh.shape}")
    return mesh


def nchw(img) -> torch.Tensor:
    return torch.as_tensor(np.asarray(img, np.float32))


def split_views(img, k: int) -> np.ndarray:
    """``[B * k, ...]`` adjacent views of a host batch -> ``[B, k, ...]`` (a
    sliced batch holds whole items, so the split is exact per slice)."""
    img = np.asarray(img, np.float32)
    return img.reshape((img.shape[0] // k, k) + img.shape[1:])


class DasslTrainer(TrainerBase):
    """Base of the SimpleNet-family trainers. Subclasses implement
    ``forward_backward(batch)`` (TrainerX) or ``forward_backward_xu(batch_x,
    batch_u)`` (:class:`TrainerXU`)."""

    # under a process group with the sliced loader each rank may decode
    # its block of every train batch; trainers whose host logic needs the
    # whole batch opt out
    SUPPORTS_LOCAL_BATCHES = True

    def __init__(self, cfg):
        self.check_cfg(cfg)
        self._init_state(cfg)
        super().__init__(cfg)

    def _init_state(self, cfg):
        """Everything but the data manager and the models: the device, the
        model registry, the step counter and the mesh."""
        from ovmr_tpu_torch.api import resolve_device

        self.cfg = cfg
        self.device = resolve_device(cfg.CUDA.DEVICE)
        self._nets: Dict[str, nn.Module] = {}
        self._optims: Dict[str, Optional[torch.optim.Optimizer]] = {}
        self._seed = max(cfg.SEED, 0)
        self._step_count = 0
        self.mesh = setup_dassl_mesh(cfg, label=f"{type(self).__name__}: ")
        axis = None if self.mesh is None else self.mesh.data
        self.axis = axis
        # under a process group every row-mean loss is this rank's share
        self.loss_scale = 1.0 / axis.size if axis is not None and axis.group else 1.0

    def build_data_manager(self):
        from ovmr_tpu_torch.data.manager import DataManager

        return DataManager(self.cfg, allow_local_batches=type(self).SUPPORTS_LOCAL_BATCHES)

    # -- hooks ------------------------------------------------------------
    def check_cfg(self, cfg):
        pass

    @property
    def num_classes(self):
        return self.dm.num_classes

    @property
    def num_source_domains(self):
        return self.dm.num_source_domains

    # -- model registry (reference TrainerBase.register_model) ------------
    def register_model(self, name, net: nn.Module, optimizer=None):
        assert name not in self._nets, "Found duplicate model names"
        self._nets[name] = net
        self._optims[name] = optimizer

    def get_model_names(self):
        return list(self._nets)

    def build_net(self, net: nn.Module) -> nn.Module:
        """A new model on the trainer's device in fp32 (its random init is
        drawn from torch's generator, which ``train.main`` seeds from
        ``SEED``)."""
        return net.to(self.device, torch.float32)

    def build_optim(self, net: nn.Module) -> torch.optim.Optimizer:
        """``OPTIM`` over the model's parameters, keyed as the flax params
        tree (the JAX Dassl trainers build no staged groups either)."""
        if bool(self.cfg.OPTIM.STAGED_LR):
            raise ValueError("OPTIM.STAGED_LR requires staged_labels (build with "
                             "staged_lr_labels(params, cfg.OPTIM.NEW_LAYERS))")
        return build_optimizer(self.cfg.OPTIM, _param_tree(net))

    def step_generator(self) -> torch.Generator:
        """This step's generator (seeded from the seed and the global step
        counter, so resumed runs continue the stream)."""
        self._step_count += 1
        seed = hash((self._seed, self._step_count)) & 0x7FFFFFFFFFFFFFFF
        return torch.Generator(device=self.device).manual_seed(seed)

    @contextlib.contextmanager
    def step_scope(self, *rows: int):
        """A step's context: fp32 without TF32, this step's generator for the
        modules' draws, and the data axis for BatchNorm when each of the
        step's batches (``rows``: the row counts its BatchNorms see) splits
        over its local shards (on one process a batch that does not split
        runs as one program, which computes the same statistics). Under a
        process group a forward's rows are this rank's block of its batch,
        whose dropout mask is drawn whole (:func:`F.row_window`), unless the
        step says otherwise (:meth:`forward_groups`)."""
        axis = self.axis
        if axis is not None and axis.group is None and any(r % len(axis.shards) for r in rows):
            axis = None
        window = None
        if axis is not None and axis.group is not None:
            d, size = axis.shards[0], axis.size
            window = lambda n: (d * n, size * n)  # noqa: E731
        with exact_fp32_convolutions(), F.rng_scope(self.step_generator()) as gen:
            with data_axis_scope(axis) if axis is not None else contextlib.nullcontext():
                with F.row_window(window):
                    yield gen

    def sync_grads(self, *nets: nn.Module) -> None:
        """Sum the gradients over the data axis' process group (a no-op
        without one)."""
        if self.axis is None or self.axis.group is None:
            return
        for net in nets:
            for p in net.parameters():
                if p.grad is not None:
                    self.axis.sum_(p.grad)

    def global_value(self, value: torch.Tensor) -> float:
        """A logged scalar over the whole batch: this rank's share summed
        over the group (a ``loss_scale``-weighted loss), else itself."""
        return self.global_sums(value)[0]

    def global_sums(self, *values: torch.Tensor) -> list:
        """Scalars summed over the data axis' process group (themselves
        without one), in one all-reduce, as floats."""
        sums = torch.stack([v.detach().float().reshape(()) for v in values])
        if self.axis is not None and self.axis.group is not None:
            sums = self.axis.sum_(sums)
        return [float(v) for v in sums]

    # -- rows across the data axis' ranks ----------------------------------
    def row_offset(self, n_local: int) -> int:
        """The batch index of the first of this process's ``n_local`` rows:
        its data shard's block under a process group, 0 otherwise."""
        if self.axis is None or self.axis.group is None:
            return 0
        return self.axis.shards[0] * n_local

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of a batch whose block this process holds, in
        the batch's order: under a process group the data axis' all-gather,
        whose backward sums the cotangents over the ranks (so a loss that
        every rank computes whole, scaled by ``loss_scale``, gives each
        rank's rows their whole gradient); ``x`` itself otherwise."""
        if self.axis is None or self.axis.group is None:
            return x
        return self.axis.gather([x])

    def own_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This process's block of a batch it holds whole (the inverse of
        :meth:`gather_rows`)."""
        from ovmr_tpu_torch.parallel.mesh import shard_batch

        return x if self.mesh is None else shard_batch(self.mesh, x)

    def domain_groups(self, x: torch.Tensor, n_domain: int, split: int) -> list:
        """This process's rows of each domain group of a
        ``RandomDomainSampler`` batch (``[n_domain, split]`` rows of the
        whole batch), in group order, each as ``(rows, offset)``: the rows
        and the index of the first in its group. On one process these are
        the groups; under a process group a rank's block cuts across them,
        so a group's rows may be split over the ranks or none of them this
        rank's (an empty piece: the rank still forwards it, joining the
        group's BatchNorm collectives in the same order as the others)."""
        lo = self.row_offset(x.shape[0])
        hi = lo + x.shape[0]
        pieces = []
        for g in range(n_domain):
            a = min(max(g * split, lo), hi)
            b = max(min((g + 1) * split, hi), a)
            pieces.append((x[a - lo:b - lo], a - g * split))
        return pieces

    @staticmethod
    def forward_groups(net: nn.Module, pieces: list, split: int) -> list:
        """``net`` on each of :meth:`domain_groups`' pieces in turn: within a
        step's scope each group's BatchNorm statistics are those of all its
        rows, and dropout draws the group's mask and keeps these rows."""
        outs = []
        for rows, offset in pieces:
            with F.row_window(lambda n, offset=offset: (offset, split)):
                outs.append(net(rows))
        return outs

    def backward_and_update(self, loss: torch.Tensor, names) -> None:
        """One update of the models ``names`` from ``loss`` (this rank's
        share), their gradients summed over the data axis first."""
        names = [names] if isinstance(names, str) else list(names)
        for name in names:
            self._optims[name].zero_grad(set_to_none=True)
        loss.backward()
        self.sync_grads(*(self._nets[n] for n in names))
        for name in names:
            self._optims[name].step()

    # -- default build: one SimpleNet + optimizer + schedule ---------------
    def build_model(self):
        cfg = self.cfg
        print("Building model")
        self.net = self.build_net(build_simplenet(cfg, cfg.MODEL, self.dm.num_classes))
        if cfg.MODEL.INIT_WEIGHTS:
            load_init_weights(self.net, cfg.MODEL.INIT_WEIGHTS)
        print(f"# params: {sum(p.numel() for p in self.net.parameters()):,}")
        self.optim = self.build_optim(self.net)
        self.register_model("model", self.net, self.optim)
        self.lr_table = lr_schedule_from_cfg(cfg.OPTIM)

    def model_state(self, name: str = "model") -> dict:
        """A registered model's state as the JAX package's flax state
        (numpy ``params`` and ``batch_stats``)."""
        return dassl_state_to_numpy(self._nets[name])

    # -- epoch/step plumbing ----------------------------------------------
    def before_epoch(self):
        for opt in self._optims.values():
            if opt is not None:
                set_lr(opt, self.lr_table[self.epoch])

    def rows(self, x, local: bool = False) -> torch.Tensor:
        """This process's rows of a host batch on the device: its data
        shard's block under a process group (a sliced batch is that block
        already), every row otherwise."""
        from ovmr_tpu_torch.parallel.mesh import shard_batch

        x = torch.as_tensor(np.asarray(x))
        if self.mesh is not None and not local:
            x = shard_batch(self.mesh, x)
        elif local and self.mesh is None:
            raise RuntimeError("sliced multi-host batch without a mesh — set CUDA.MESH.DATA "
                               "!= 1 or disable CUDA.MULTIHOST_SLICED_LOADER")
        return x.to(self.device, non_blocking=True)

    def batch_rows(self, batch, key, dtype=np.float32) -> torch.Tensor:
        """This process's rows of ``batch[key]`` on the device (a batch that
        the sliced loader decoded, ``_local``, holds only them)."""
        return self.rows(np.asarray(batch[key], dtype), bool(batch.get("_local", False)))

    def parse_batch_train(self, batch):
        if "domain" not in batch:
            batch = {**batch, "domain": np.zeros_like(batch["label"])}
        return (self.batch_rows(batch, "img"), self.batch_rows(batch, "label", np.int64),
                self.batch_rows(batch, "domain", np.int64))

    def forward_backward(self, batch):
        img, label, _ = self.parse_batch_train(batch)
        net = self._nets["model"]
        net.train()
        with self.step_scope(img.shape[0]):
            out = net(img)
            loss = F.cross_entropy(out, label) * self.loss_scale
            self.backward_and_update(loss, "model")
        acc = (out.argmax(1) == label).float().mean() * 100.0 * self.loss_scale
        return {"loss": self.global_value(loss), "acc": self.global_value(acc)}

    # -- inference / eval --------------------------------------------------
    def eval_images(self, batch) -> torch.Tensor:
        """Eval batches arrive NCHW float (host-normalised) or HWC uint8
        (``CUDA.EVAL_UINT8_TRANSFER``: normalised on the device, the same
        numbers)."""
        img = np.asarray(batch["img"])
        if img.dtype == np.uint8:
            x = torch.as_tensor(img).to(self.device).float() / 255.0
            if "normalize" in self.cfg.INPUT.TRANSFORMS:
                mean = torch.tensor(self.cfg.INPUT.PIXEL_MEAN, device=self.device)
                std = torch.tensor(self.cfg.INPUT.PIXEL_STD, device=self.device)
                x = (x - mean) / std
            return x.permute(0, 3, 1, 2).contiguous()
        return nchw(img).to(self.device)

    @torch.no_grad()
    def model_inference(self, batch, scale_no=0):
        # the first registered model (the label net: "model", or "F" for
        # the F/D/G-style trainers); ensemble trainers override
        x = self.eval_images(batch)
        net = next(iter(self._nets.values()))
        net.eval()
        with exact_fp32_convolutions():
            return net(x).float().cpu().numpy()

    # -- checkpointing (npz subdir-per-model + pointer) --------------------
    def _named_params(self, name):
        """The optimizer's parameters as the flax params tree names them,
        with the layout maps of :func:`ovmr_tpu_torch.convert.dassl_leaves`."""
        return [(ckpt.SEP.join(leaf.path), leaf.tensor, leaf.to_flax, leaf.from_flax)
                for leaf in dassl_leaves(self._nets[name]) if leaf.collection == "params"]

    def save_model(self, epoch, model_name=""):
        for name in self._nets:
            ckpt.save_checkpoint(self.output_dir, name, epoch, self._state_tensors(name),
                                 self._optims[name], model_name=model_name,
                                 backend=self.cfg.CUDA.CHECKPOINT_BACKEND,
                                 opt_params=self._named_params(name))

    def _state_tensors(self, name):
        """A registered model's flax state as CPU tensors."""
        return {coll: _to_tensors(tree) for coll, tree in self.model_state(name).items()}

    def _load(self, directory, name, epoch=None, prefer="best", backend="npz"):
        tree, opt, ep = ckpt.load_checkpoint(directory, name, self._state_tensors(name),
                                             epoch=epoch, prefer=prefer, backend=backend)
        dassl_state_from_numpy(self._nets[name], {c: _to_numpy(t) for c, t in tree.items()})
        return opt, ep

    def resume_model_if_exist(self, directory) -> int:
        """Each registered model's latest checkpoint, its optimizer state
        included: with ``CUDA.CHECKPOINT_BACKEND orbax`` the orbax pointer
        first, then the npz one (JAX ``dassl_base.py:476-491``)."""
        start = 0
        for name in self._nets:
            try:
                opt, epoch = self._load(directory, name, prefer="pointer",
                                        backend=self.cfg.CUDA.CHECKPOINT_BACKEND)
            except FileNotFoundError:
                continue
            if self._optims[name] is not None and opt is not None:
                ckpt.load_optimizer_state(self._optims[name], self._named_params(name), opt)
            print(f"Resumed {name} from epoch {epoch}")
            start = max(start, epoch)
        return start

    def load_model(self, directory, epoch=None):
        if not directory:
            print("Note that load_model() is skipped as no pretrained model is given "
                  "(ignore this if it's done on purpose)")
            return
        for name in self._nets:
            _, ep = self._load(directory, name, epoch=epoch)
            print(f"Load model '{name}' from {directory} (epoch={ep})")


def _param_tree(net: nn.Module) -> dict:
    """The module's parameters as a nested dict keyed by their flax paths."""
    tree = {}
    for leaf in dassl_leaves(net):
        if leaf.collection == "params":
            node = tree
            for p in leaf.path[:-1]:
                node = node.setdefault(p, {})
            node[leaf.path[-1]] = leaf.tensor
    return tree


def _to_tensors(tree):
    return {k: _to_tensors(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


def _to_numpy(tree):
    return {k: _to_numpy(v) if isinstance(v, dict) else v.numpy() for k, v in tree.items()}


class TrainerX(DasslTrainer):
    """Labeled-only epoch loop — TrainerBase's (reference
    ``dassl/engine/trainer.py:620-674``)."""


class TrainerXU(DasslTrainer):
    """Dual labeled/unlabeled epoch loop (reference
    ``dassl/engine/trainer.py:530-617``): ``TRAIN.COUNT_ITER`` batches an
    epoch, restarting whichever loader runs out first. Subclasses implement
    ``forward_backward_xu(batch_x, batch_u)``."""

    def forward_backward_xu(self, batch_x, batch_u):
        raise NotImplementedError

    def run_epoch(self):
        cfg = self.cfg
        loader_x = self.dm.train_loader_x
        loader_u = getattr(self.dm, "train_loader_u", None)
        if loader_u is None:
            raise RuntimeError(
                f"{type(self).__name__} needs an unlabeled split (dataset.train_u is empty)")
        len_x, len_u = len(loader_x), len(loader_u)
        if cfg.TRAIN.COUNT_ITER == "train_x":
            num_batches = len_x
        elif cfg.TRAIN.COUNT_ITER == "train_u":
            num_batches = len_u
        elif cfg.TRAIN.COUNT_ITER == "smaller_one":
            num_batches = min(len_x, len_u)
        else:
            raise ValueError(cfg.TRAIN.COUNT_ITER)
        self.num_batches = num_batches

        losses = MetricMeter()
        self.batch_time = batch_time = AverageMeter()
        self.data_time = data_time = AverageMeter()
        iter_x = iter(prefetch_batches(loader_x))
        iter_u = iter(prefetch_batches(loader_u))
        end = time.time()
        for self.batch_idx in range(num_batches):
            try:
                batch_x = next(iter_x)
            except StopIteration:
                iter_x = iter(prefetch_batches(loader_x))
                batch_x = next(iter_x)
            try:
                batch_u = next(iter_u)
            except StopIteration:
                iter_u = iter(prefetch_batches(loader_u))
                batch_u = next(iter_u)
            data_time.update(time.time() - end)
            loss_summary = self.forward_backward_xu(batch_x, batch_u)
            batch_time.update(time.time() - end)
            if loss_summary:
                loss_val = loss_summary.get("loss")
                if loss_val is not None and not np.isfinite(loss_val):
                    raise FloatingPointError(
                        f"non-finite loss {loss_val} at epoch {self.epoch} batch {self.batch_idx}")
                losses.update(loss_summary)
                step = self.epoch * num_batches + self.batch_idx
                for k, v in loss_summary.items():
                    self.write_scalar(f"train/{k}", v, step)
            if (self.batch_idx + 1) % cfg.TRAIN.PRINT_FREQ == 0 or num_batches < cfg.TRAIN.PRINT_FREQ:
                nb_remain = (num_batches - self.batch_idx - 1) + (
                    self.max_epoch - self.epoch - 1) * num_batches
                eta = datetime.timedelta(seconds=int(batch_time.avg * nb_remain))
                print(f"epoch [{self.epoch + 1}/{self.max_epoch}]"
                      f"[{self.batch_idx + 1}/{num_batches}]\t"
                      f"time {batch_time.val:.3f} ({batch_time.avg:.3f})\t"
                      f"data {data_time.val:.3f} ({data_time.avg:.3f})\t"
                      f"{losses}\teta {eta}")
            end = time.time()

    def forward_backward(self, batch):  # pragma: no cover - the XU loop only
        raise RuntimeError("TrainerXU drives forward_backward_xu")
