"""Classification evaluator.

The port's copy of ``ovmr_tpu/evaluation/evaluator.py`` (reference
``dassl/evaluation/evaluator.py:50-173``): running accuracy, macro-F1
restricted to the labels present in y_true, per-class accuracy / F1 CSV
artifacts in OUTPUT_DIR (F1 rows keyed by enumerate, the reference's
quirk), the exact ``=> result`` log block the result parser scrapes, an
optional per-class breakdown and confusion matrix. The F1 scores and the
confusion matrix are computed here in numpy with sklearn's formulas
(``f1_score(labels=present, zero_division=0)``, ``confusion_matrix(
normalize="true")``), so the port does not need sklearn.
"""

from __future__ import annotations

import csv
import os.path as osp
from collections import OrderedDict, defaultdict
from typing import Dict, Optional

import numpy as np

from ovmr_tpu_torch.utils.registry import Registry

EVALUATOR_REGISTRY = Registry("EVALUATOR")


def build_evaluator(cfg, lab2cname: Optional[Dict[int, str]] = None):
    return EVALUATOR_REGISTRY.get(cfg.TEST.EVALUATOR)(cfg, lab2cname=lab2cname)


@EVALUATOR_REGISTRY.register()
class Classification:
    def __init__(self, cfg, lab2cname: Optional[Dict[int, str]] = None):
        self.cfg = cfg
        self._lab2cname = lab2cname or {}
        self._per_class_res = defaultdict(list) if cfg.TEST.PER_CLASS_RESULT else None
        self.reset()

    def reset(self) -> None:
        self._correct = 0
        self._total = 0
        self._y_true = []
        self._y_pred = []
        if self._per_class_res is not None:
            self._per_class_res = defaultdict(list)

    def process(self, model_output, ground_truth, topk: int = 1) -> None:
        mo = np.asarray(model_output)
        gt = np.asarray(ground_truth)
        if topk == 1:
            pred = mo.argmax(axis=1)
            matches = (pred == gt).astype(np.float64)
        else:
            topk_pred = np.argsort(-mo, axis=1)[:, :topk]
            matches = (topk_pred == gt[:, None]).any(axis=1).astype(np.float64)
            pred = topk_pred[:, 0]
        self._correct += int(matches.sum())
        self._total += int(gt.shape[0])
        self._y_true.extend(gt.tolist())
        self._y_pred.extend(pred.tolist())
        if self._per_class_res is not None:
            for label, m in zip(gt.tolist(), matches.tolist()):
                self._per_class_res[label].append(int(m))

    def evaluate(self) -> "OrderedDict[str, float]":
        results = OrderedDict()
        acc = 100.0 * self._correct / max(self._total, 1)
        err = 100.0 - acc
        y_true = np.asarray(self._y_true)
        y_pred = np.asarray(self._y_pred)
        present = np.unique(y_true)

        # per-class acc CSV
        acc_by_class = {}
        for label in present:
            sel = y_true == label
            acc_by_class[str(label)] = 100.0 * (y_pred[sel] == label).mean()
        self._write_csv(
            "acc_per_class.csv", ["Label", "Acc"], sorted(acc_by_class.items())
        )

        f1_per_class = 100.0 * f1_scores(y_true, y_pred, present)
        self._write_csv(
            "f1_per_class.csv", ["Label", "F1"], list(enumerate(f1_per_class))
        )

        macro_f1 = 100.0 * float(np.mean(f1_scores(y_true, y_pred, present)))

        results["accuracy"] = acc
        results["error_rate"] = err
        results["macro_f1"] = macro_f1

        print(
            "=> result\n"
            f"* total: {self._total:,}\n"
            f"* correct: {self._correct:,}\n"
            f"* accuracy: {acc:.1f}%\n"
            f"* error: {err:.1f}%\n"
            f"* macro_f1: {macro_f1:.1f}%"
        )

        if self._per_class_res is not None:
            print("=> per-class result")
            accs = []
            for label in sorted(self._per_class_res):
                res = self._per_class_res[label]
                pc_acc = 100.0 * sum(res) / len(res)
                accs.append(pc_acc)
                cname = self._lab2cname.get(label, str(label))
                print(
                    f"* class: {label} ({cname})\t"
                    f"total: {len(res):,}\t"
                    f"correct: {sum(res):,}\t"
                    f"acc: {pc_acc:.1f}%"
                )
            mean_acc = float(np.mean(accs))
            print(f"* average: {mean_acc:.1f}%")
            results["perclass_accuracy"] = mean_acc

        if self.cfg.TEST.COMPUTE_CMAT:
            import torch

            cmat = confusion_matrix_true(y_true, y_pred)
            # reference artifact format (torch.save, evaluator.py:166-169)
            save_path = osp.join(self.cfg.OUTPUT_DIR, "cmat.pt")
            torch.save(cmat, save_path)
            print(f"Confusion matrix is saved to {save_path}")

        return results

    def _write_csv(self, filename, header, rows):
        try:
            path = osp.join(self.cfg.OUTPUT_DIR, filename)
            with open(path, "w", newline="") as f:
                writer = csv.writer(f, delimiter=",")
                writer.writerow(header)
                for key, value in rows:
                    writer.writerow([key, value])
        except OSError:
            pass


def f1_scores(y_true: np.ndarray, y_pred: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """Per-label F1 over ``labels`` as sklearn's ``f1_score(average=None,
    labels=labels, zero_division=0)`` computes it: ``2 tp / (true + pred)``
    in float64, 0 where a label is neither true nor predicted."""
    n = int(max(y_true.max(initial=0), y_pred.max(initial=0), labels.max(initial=0))) + 1

    def counts(values):
        return np.bincount(values, minlength=n)[labels].astype(np.float64)

    tp = counts(y_true[y_true == y_pred])
    denom = counts(y_true) + counts(y_pred)
    return np.divide(2.0 * tp, denom, out=np.zeros_like(denom), where=denom != 0)


def confusion_matrix_true(y_true: np.ndarray, y_pred: np.ndarray) -> np.ndarray:
    """sklearn's ``confusion_matrix(y_true, y_pred, normalize="true")``: rows
    and columns over the sorted union of the labels, each row divided by its
    count."""
    labels = np.union1d(y_true, y_pred)
    index = {int(l): i for i, l in enumerate(labels)}
    cm = np.zeros((len(labels), len(labels)), np.int64)
    for t, p in zip(y_true.tolist(), y_pred.tolist()):
        cm[index[t], index[p]] += 1
    with np.errstate(all="ignore"):
        cm = cm / cm.sum(axis=1, keepdims=True)
    return np.nan_to_num(cm)
