"""Softmax eval confusion matrix, a host numpy object (counterpart of
``nunif_tpu/training/confusion_matrix.py``)."""
from __future__ import annotations

import numpy as np


def _host(a):
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


class SoftmaxConfusionMatrix:
    def __init__(self, num_classes: int, class_names=None):
        self.num_classes = num_classes
        self.class_names = class_names or [str(i) for i in range(num_classes)]
        self.matrix = np.zeros((num_classes, num_classes), np.int64)

    def update(self, logits, labels):
        preds = _host(logits).argmax(axis=-1).ravel()
        labels = _host(labels).ravel()
        np.add.at(self.matrix, (labels, preds), 1)

    def clear(self):
        self.matrix[:] = 0

    @property
    def accuracy(self) -> float:
        total = self.matrix.sum()
        return float(np.trace(self.matrix) / total) if total else 0.0

    def average_row_correct(self) -> float:
        rows = self.matrix.sum(axis=1)
        ok = np.divide(np.diag(self.matrix), rows,
                       out=np.zeros(self.num_classes), where=rows > 0)
        return float(ok.mean())

    def __str__(self):
        lines = [f"accuracy: {self.accuracy:.4f} "
                 f"(avg row correct: {self.average_row_correct():.4f})"]
        for i, name in enumerate(self.class_names):
            row = self.matrix[i]
            total = row.sum() or 1
            lines.append(f"  {name}: {row[i]}/{row.sum()} "
                         f"({row[i] / total:.3f})")
        return "\n".join(lines)
