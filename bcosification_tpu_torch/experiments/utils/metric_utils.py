"""The metrics history (the port's copy of
``bcosification_tpu/experiments/utils/metric_utils.py``): ``Metrics``, a
dict {name: [(epoch, value), ...]} loaded from an experiment's
``metrics/metrics.json.gz``, with best-epoch search, and
``MultiLabelMetrics``, the multilabel counts and scores at a logit
threshold.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

__all__ = ["Metrics", "MultiLabelMetrics"]


class Metrics(dict):
    """{name: [(epoch, value), ...]} with best-epoch lookup."""

    @classmethod
    def load(cls, experiment) -> "Metrics":
        return cls(experiment.load_metrics())

    def series(self, name: str) -> Tuple[List[int], List[float]]:
        entries = self.get(name, [])
        return [int(e) for e, _ in entries], [float(v) for _, v in entries]

    def best_epoch(self, name: str = "val_acc1", mode: str = "max") -> Optional[int]:
        entries = self.get(name)
        if not entries:
            return None
        key = (lambda t: t[1]) if mode == "max" else (lambda t: -t[1])
        return int(max(entries, key=key)[0])

    def best_value(self, name: str = "val_acc1", mode: str = "max") -> Optional[float]:
        entries = self.get(name)
        if not entries:
            return None
        vals = [v for _, v in entries]
        return max(vals) if mode == "max" else min(vals)

    def last(self, name: str) -> Optional[float]:
        entries = self.get(name)
        return float(entries[-1][1]) if entries else None


class MultiLabelMetrics:
    """Accumulating multilabel classification metrics at a logit threshold:
    a numpy accumulator whose ``compute()`` gives Accuracy / Precision /
    Recall / F-Score and the confusion counts."""

    def __init__(self, num_classes: int, threshold: float):
        self.num_classes = num_classes
        self.threshold = threshold
        self.reset()

    def reset(self):
        self.true_positives = 0.0
        self.false_positives = 0.0
        self.true_negatives = 0.0
        self.false_negatives = 0.0

    def update(self, logits, labels):
        import numpy as np

        logits = np.asarray(logits)
        labels = np.asarray(labels)
        pred = logits >= self.threshold
        pos = labels == 1.0
        self.true_positives += float(np.sum(pred & pos))
        self.false_negatives += float(np.sum(~pred & pos))
        self.false_positives += float(np.sum(pred & ~pos))
        self.true_negatives += float(np.sum(~pred & ~pos))

    def compute(self):
        tp, fp = self.true_positives, self.false_positives
        tn, fn = self.true_negatives, self.false_negatives
        total = tp + tn + fp + fn
        self.accuracy = (tp + tn) / total if total else 0.0
        self.precision = tp / (tp + fp) if tp + fp else 0.0
        self.recall = tp / (tp + fn) if tp + fn else 0.0
        self.f_score = (2 * tp) / (2 * tp + fp + fn) if 2 * tp + fp + fn else 0.0
        return {
            "Accuracy": self.accuracy,
            "Precision": self.precision,
            "Recall": self.recall,
            "F-Score": self.f_score,
            "True Positives": tp,
            "True Negatives": tn,
            "False Positives": fp,
            "False Negatives": fn,
        }

    def save(self, model: str, classifier_type: str, dataset: str):
        m = self.compute()
        with open(f"{model}_{classifier_type}_{dataset}_test_metrics.txt", "w") as f:
            f.write(
                f"Accuracy: {m['Accuracy']}\nPrecision: {m['Precision']}\n"
                f"Recall: {m['Recall']}\nF-Score: {m['F-Score']}"
            )
