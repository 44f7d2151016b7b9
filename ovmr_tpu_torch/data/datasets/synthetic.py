"""Synthetic dataset for tests, demos and benchmarking.

The port's copy of ``Synthetic`` from ``ovmr_tpu/data/datasets/synthetic.py``
(no reference counterpart): deterministic colored-noise PNGs per class,
written on first use, so the whole pipeline (loader -> transform -> encode
-> classifier generation -> eval) runs anywhere with zero downloads. The
files, paths and splits are the JAX package's, pixel for pixel: the random
draws are taken in the same order from one ``default_rng(0)``, and only
the arithmetic after them and the PNG writes run on a thread pool.
``SyntheticSSL`` (JAX ``:120``) is the semi-supervised variant the SSL
trainers run on, ``SyntheticDA`` (JAX ``:141``) the domain-adaptation one
of the DG and DA trainers.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import os.path as osp
import random
import tempfile

import numpy as np

from ovmr_tpu_torch.utils.tools import mkdir_if_missing

from ..datum import DatasetBase, Datum, generate_fewshot_dataset, subsample_classes
from ..registry import DATASET_REGISTRY

_CLASSNAMES = [
    "red circle",
    "green square",
    "blue triangle",
    "yellow stripes",
    "purple dots",
    "orange grid",
    "cyan waves",
    "magenta noise",
]

_HUES = np.asarray(
    [
        [1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0],
        [0.6, 0, 0.8], [1, 0.5, 0], [0, 0.9, 0.9], [1, 0, 1],
    ],
    np.float32,
)

# images whose draws are taken ahead of the thread pool's writes
_WRITE_AHEAD = 64


def _draws(rng: np.random.Generator, size: int):
    """One image's random draws, in the JAX package's order: the hue's
    brightness, the noise, and the noise pattern's field (drawn for every
    label there, because its list of patterns is built whole)."""
    return (
        rng.uniform(0.4, 0.9),
        rng.normal(0, 0.08, (size, size, 3)),
        rng.uniform(size=(size, size)),
    )


def _make_image(label: int, size: int, draws) -> np.ndarray:
    brightness, noise, field = draws
    base = np.zeros((size, size, 3), np.float32)
    base += _HUES[label % 8] * brightness
    base += noise.astype(np.float32)
    yy, xx = np.mgrid[0:size, 0:size] / size
    pattern = (
        lambda: ((yy - 0.5) ** 2 + (xx - 0.5) ** 2) < 0.1,
        lambda: (abs(yy - 0.5) < 0.25) & (abs(xx - 0.5) < 0.25),
        lambda: yy > xx,
        lambda: np.sin(yy * 20) > 0,
        lambda: (np.sin(yy * 30) * np.sin(xx * 30)) > 0.5,
        lambda: (np.sin(yy * 25) > 0) | (np.sin(xx * 25) > 0.5),
        lambda: np.sin((yy + xx) * 15) > 0,
        lambda: field > 0.5,
    )[label % 8]()
    base[pattern] = 1.0 - base[pattern]
    return (np.clip(base, 0, 1) * 255).astype(np.uint8)


def _write_png(path: str, label: int, size: int, draws) -> None:
    from PIL import Image

    Image.fromarray(_make_image(label, size, draws)).save(path)


@DATASET_REGISTRY.register()
class Synthetic(DatasetBase):
    dataset_dir = "synthetic"

    def __init__(self, cfg, num_classes: int = 8, per_class: int = 24, size: int = 224):
        # scale knobs for perf soaks (the registry instantiates with cfg
        # only): OVMR_SYNTHETIC=classes,per_class,size
        spec = os.environ.get("OVMR_SYNTHETIC")
        if spec:
            parts = spec.split(",")
            try:
                if len(parts) != 3:
                    raise ValueError
                num_classes, per_class, size = (int(v) for v in parts)
            except ValueError:
                raise ValueError(
                    f"OVMR_SYNTHETIC={spec!r} is malformed; expected "
                    "'classes,per_class,size' (three comma-separated ints, "
                    "e.g. '64,24,224')"
                ) from None

        root = osp.abspath(osp.expanduser(
            cfg.DATASET.ROOT or osp.join(tempfile.gettempdir(), "ovmr_data")))
        base = osp.join(root, type(self).dataset_dir, f"c{num_classes}_n{per_class}_s{size}")
        rng = np.random.default_rng(0)

        items = []
        with cf.ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
            pending = []
            for label in range(num_classes):
                cname = _CLASSNAMES[label % len(_CLASSNAMES)]
                cdir = osp.join(base, f"{label:03d}")
                mkdir_if_missing(cdir)
                for i in range(per_class):
                    path = osp.join(cdir, f"{i:04d}.png")
                    if not osp.exists(path):
                        pending.append(pool.submit(_write_png, path, label, size,
                                                   _draws(rng, size)))
                        if len(pending) >= _WRITE_AHEAD:
                            for job in pending:
                                job.result()
                            pending = []
                    items.append(Datum(impath=path, label=label, classname=cname))
            for job in pending:
                job.result()

        per = per_class
        train = [d for i, d in enumerate(items) if i % per < per // 2]
        val = [d for i, d in enumerate(items) if per // 2 <= i % per < (3 * per) // 4]
        test = [d for i, d in enumerate(items) if i % per >= (3 * per) // 4]

        if cfg.DATASET.NUM_SHOTS >= 1:
            # seeded few-shot sampling: deterministic per cfg.SEED without
            # relying on the global RNG state at construction time
            train = generate_fewshot_dataset(
                train,
                num_shots=cfg.DATASET.NUM_SHOTS,
                rng=random.Random(max(cfg.SEED, 0)),
            )
        train, val, test = subsample_classes(
            train, val, test, subsample=cfg.DATASET.SUBSAMPLE_CLASSES
        )
        super().__init__(train_x=train, val=val, test=test, eval_set=train)


@DATASET_REGISTRY.register()
class SyntheticSSL(Synthetic):
    """Semi-supervised variant: the train split is divided into a labeled
    part (``DATASET.NUM_LABELED`` items, default half) and an unlabeled
    ``train_u`` pool, the shape of the reference SSL datasets
    (``dassl/data/datasets/ssl/cifar.py``); ``ALL_AS_UNLABELED`` puts the
    labeled part in the pool too."""

    def __init__(self, cfg, **kwargs):
        super().__init__(cfg, **kwargs)
        full = self.train_x
        n_labeled = cfg.DATASET.NUM_LABELED
        if n_labeled <= 0:
            n_labeled = len(full) // 2
        self.train_x = full[:n_labeled]
        self.train_u = [
            Datum(impath=d.impath, label=d.label, classname=d.classname)
            for d in (full if cfg.DATASET.ALL_AS_UNLABELED else full[n_labeled:])
        ]
        self.eval_set = self.train_x


@DATASET_REGISTRY.register()
class SyntheticDA(Synthetic):
    """Domain-adaptation variant: train_x becomes the source domains
    (domain ids cycle over ``len(DATASET.SOURCE_DOMAINS)`` or 2) and the
    val split doubles as the unlabeled target pool ``train_u`` (domain =
    n_sources), the shape of the reference DA datasets' source/target split
    (``dassl/data/datasets/da/``)."""

    def __init__(self, cfg, **kwargs):
        super().__init__(cfg, **kwargs)
        n_dom = max(len(cfg.DATASET.SOURCE_DOMAINS), 2)
        self.train_x = [
            Datum(impath=d.impath, label=d.label, domain=i % n_dom, classname=d.classname)
            for i, d in enumerate(self.train_x)
        ]
        self.train_u = [
            Datum(impath=d.impath, label=d.label, domain=n_dom, classname=d.classname)
            for d in self.val
        ]
        self.eval_set = self.train_x
