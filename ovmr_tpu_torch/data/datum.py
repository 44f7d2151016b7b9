"""Dataset record types, splits, few-shot sampling and class subsampling.

The port's copy of ``ovmr_tpu/data/datum.py``.

Format-compatible with the reference data layer so its on-disk artifacts
load directly:

- ``split_zhou_*.json`` 3-way splits (``datasets/oxford_pets.py:99-138``);
- few-shot pickle caches ``split_fewshot/shot_{N}-seed_{S}.pkl`` holding
  lists of Dassl ``Datum`` objects (a compat unpickler maps them onto ours);
- ``subsample_classes`` base/new halving with relabeling
  (``datasets/oxford_pets.py:140-201``): sorted labels, first ceil(n/2) are
  base, rest are new, relabeled 0..m-1.
"""

from __future__ import annotations

import json
import math
import os.path as osp
import pickle
import random
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

from ovmr_tpu_torch.utils.tools import mkdir_if_missing


@dataclass
class Datum:
    impath: str = ""
    label: int = 0
    domain: int = 0
    classname: str = ""


class _CompatUnpickler(pickle.Unpickler):
    """Unpickle reference caches: maps dassl's Datum class onto ours."""

    def find_class(self, module, name):
        if name == "Datum":
            return _DatumFromDassl
        return super().find_class(module, name)


class _DatumFromDassl:
    """Shim accepting dassl Datum pickle state (attribute dict with
    underscore-prefixed fields)."""

    def __setstate__(self, state):
        self.__dict__.update(state)

    def to_datum(self) -> Datum:
        d = self.__dict__
        return Datum(
            impath=d.get("_impath", d.get("impath", "")),
            label=int(d.get("_label", d.get("label", 0))),
            domain=int(d.get("_domain", d.get("domain", 0)) or 0),
            classname=d.get("_classname", d.get("classname", "")),
        )


def _normalize_items(items) -> List[Datum]:
    out = []
    for it in items:
        if isinstance(it, Datum):
            out.append(it)
        elif isinstance(it, _DatumFromDassl):
            out.append(it.to_datum())
        else:  # dict-like
            out.append(Datum(**it))
    return out


def load_fewshot_pickle(path: str) -> Dict[str, List[Datum]]:
    with open(path, "rb") as f:
        data = _CompatUnpickler(f).load()
    return {k: _normalize_items(v) for k, v in data.items()}


def save_fewshot_pickle(path: str, data: Dict[str, List[Datum]]) -> None:
    mkdir_if_missing(osp.dirname(path))
    with open(path, "wb") as f:
        pickle.dump(data, f, protocol=pickle.HIGHEST_PROTOCOL)


# --------------------------------------------------------------------------
# json split IO (split_zhou_*.json format)
# --------------------------------------------------------------------------

def read_split(filepath: str, path_prefix: str) -> Tuple[List[Datum], List[Datum], List[Datum]]:
    def _convert(rows):
        return [
            Datum(
                impath=osp.join(path_prefix, impath),
                label=int(label),
                classname=classname,
            )
            for impath, label, classname in rows
        ]

    with open(filepath, "r") as f:
        split = json.load(f)
    return _convert(split["train"]), _convert(split["val"]), _convert(split["test"])


def save_split(
    train: Sequence[Datum],
    val: Sequence[Datum],
    test: Sequence[Datum],
    filepath: str,
    path_prefix: str,
) -> None:
    def _extract(items):
        out = []
        for item in items:
            impath = item.impath
            if impath.startswith(path_prefix):
                impath = impath[len(path_prefix) :].lstrip("/")
            out.append((impath, item.label, item.classname))
        return out

    split = {"train": _extract(train), "val": _extract(val), "test": _extract(test)}
    mkdir_if_missing(osp.dirname(filepath))
    with open(filepath, "w") as f:
        json.dump(split, f, indent=4, separators=(",", ": "))


# --------------------------------------------------------------------------
# class subsampling (base/new protocol)
# --------------------------------------------------------------------------

def subsample_classes(*splits, subsample: str = "all"):
    """Reference semantics (``oxford_pets.py:140-201``): sort labels, first
    ceil(n/2) are 'base', the rest 'new'; keep the selected classes only and
    relabel them 0..m-1 in sorted-original-label order."""
    assert subsample in ("all", "base", "new")
    if subsample == "all":
        return list(splits)

    labels = sorted({item.label for item in splits[0]})
    m = math.ceil(len(labels) / 2)
    selected = labels[:m] if subsample == "base" else labels[m:]
    relabeler = {y: i for i, y in enumerate(selected)}
    selected_set = set(selected)

    out = []
    for split in splits:
        out.append(
            [
                Datum(
                    impath=item.impath,
                    label=relabeler[item.label],
                    classname=item.classname,
                )
                for item in split
                if item.label in selected_set
            ]
        )
    return out


def generate_fewshot_dataset(
    *splits, num_shots: int = -1, repeat: bool = False, rng: random.Random | None = None
):
    """Random per-class subsample to `num_shots` items
    (reference ``base_dataset.py:175-217``; uses python `random.sample`)."""
    if num_shots < 1:
        return list(splits) if len(splits) > 1 else splits[0]
    rng = rng or random
    out = []
    for split in splits:
        by_class: Dict[int, List[Datum]] = {}
        for item in split:
            by_class.setdefault(item.label, []).append(item)
        sampled = []
        for label, items in by_class.items():
            if len(items) >= num_shots:
                sampled.extend(rng.sample(items, num_shots))
            elif repeat:
                sampled.extend(rng.choices(items, k=num_shots))
            else:
                sampled.extend(items)
        out.append(sampled)
    return out if len(out) > 1 else out[0]


def generate_fewshot_dataset_eval(
    *splits,
    num_shots: int = -1,
    repeat: bool = False,
    is_seen: bool = True,
    seed: int = 1,
    exist_few_shot_train=None,
):
    """Few-shot EVAL subsample disjoint from an existing few-shot train set
    (reference ``datasets/imagenet.py:63-128``; every reference call site is
    commented out — rebuilt here so the capability exists).

    ``is_seen=False`` is the plain per-class subsample. ``is_seen=True``
    draws ``num_shots`` items per class whose ``impath`` does NOT appear in
    ``exist_few_shot_train`` (so eval exemplars never overlap the training
    shots) and requires every class to hold at least ``2*num_shots`` items.
    Seeded and deterministic. The reference body crashes if ever called
    (``items = random.shuffle(items)`` binds None, then iterates it); this
    implements the evident intent — shuffle in place, then filter.
    """
    if num_shots < 1:
        return list(splits) if len(splits) > 1 else splits[0]
    rng = random.Random(seed)
    exist_paths_by_label: Dict[int, set] = {}
    if exist_few_shot_train is not None:
        for item in exist_few_shot_train:
            exist_paths_by_label.setdefault(item.label, set()).add(item.impath)
    out = []
    for split in splits:
        by_class: Dict[int, List[Datum]] = {}
        for item in split:
            by_class.setdefault(item.label, []).append(item)
        sampled = []
        for label, items in by_class.items():
            if not is_seen:
                if len(items) >= num_shots:
                    sampled.extend(rng.sample(items, num_shots))
                elif repeat:
                    sampled.extend(rng.choices(items, k=num_shots))
                else:
                    sampled.extend(items)
                continue
            if len(items) < 2 * num_shots:
                raise ValueError(
                    f"class {label} holds {len(items)} items < "
                    f"2*num_shots={2 * num_shots}; cannot draw disjoint "
                    "eval shots (reference: 'there are classes less than "
                    "2*num_shot!!!')"
                )
            if exist_few_shot_train is None:
                raise ValueError(
                    "is_seen=True requires exist_few_shot_train (the "
                    "training shots the eval set must be disjoint from)"
                )
            pool = list(items)
            rng.shuffle(pool)
            exist = exist_paths_by_label.get(label, set())
            picked = [it for it in pool if it.impath not in exist][:num_shots]
            if len(picked) != num_shots:
                raise ValueError(
                    f"class {label}: only {len(picked)} items outside the "
                    f"existing train shots; need {num_shots}"
                )
            sampled.extend(picked)
        out.append(sampled)
    return out if len(out) > 1 else out[0]


# --------------------------------------------------------------------------
# dataset base
# --------------------------------------------------------------------------

class DatasetBase:
    """Holds train/val/test/eval_set splits plus label bookkeeping
    (reference ``dassl/data/datasets/base_dataset.py:51-245``).
    ``eval_set`` is the exemplar source for classifier generation — the
    (few-shot) train split by default. ``train_u`` holds a dataset's
    unlabeled split (no loader reads it yet: ``train_loader_u`` comes with
    the DA and SSL trainers)."""

    # valid domain names for multi-domain (DA/DG) datasets; () = single-domain
    domains: Tuple[str, ...] = ()

    def __init__(self, train_x=None, val=None, test=None, eval_set=None, train_u=None):
        self.train_x = train_x or []
        self.train_u = train_u or []
        self.val = val or []
        self.test = test or []
        self.eval_set = eval_set if eval_set is not None else self.train_x

        # reference derives BOTH from train_x (base_dataset.py
        # get_num_classes / get_lab2cname); keep the same single source
        # so len(classnames) can never disagree with num_classes (the
        # test fallback covers eval-only synthetic datasets)
        source = self.train_x or self.test
        self.num_classes = self._count_classes(source)
        self.lab2cname, self.classnames = self._label_bookkeeping(source)

    @staticmethod
    def _count_classes(items) -> int:
        if not items:
            return 0
        return max(item.label for item in items) + 1

    @staticmethod
    def _label_bookkeeping(items):
        mapping = {}
        for item in items:
            mapping[item.label] = item.classname
        labels = sorted(mapping)
        lab2cname = {l: mapping[l] for l in labels}
        classnames = [mapping[l] for l in labels]
        return lab2cname, classnames

    def check_input_domains(self, source_domains, target_domains):
        """Validate SOURCE/TARGET domain names against ``self.domains``
        (reference ``base_dataset.py:130-142``)."""
        if not source_domains:
            raise ValueError("DATASET.SOURCE_DOMAINS is empty")
        if not target_domains:
            raise ValueError("DATASET.TARGET_DOMAINS is empty")
        for domain in tuple(source_domains) + tuple(target_domains):
            if domain not in self.domains:
                raise ValueError(
                    f"Input domain must belong to {list(self.domains)}, "
                    f"but got [{domain}]"
                )

    @staticmethod
    def split_dataset_by_domain(data_source):
        """Group a list of Datum by ``domain`` (reference
        ``base_dataset.py:233-245``)."""
        from collections import defaultdict

        output = defaultdict(list)
        for item in data_source:
            output[item.domain].append(item)
        return output
