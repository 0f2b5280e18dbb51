"""tfpark.text: the BERT text estimator of the port.

The port of ``analytics_zoo_tpu/tfpark/text/__init__.py``'s BERT entry:
``TextEstimator`` binds a model and its columns onto the port's
Estimator (``learn/estimator.py``), and ``BERTClassifier`` is sequence
classification over the port's ``BERTForSequenceClassification``
(``models/transformer.py``), trained on ``{"input_ids": [N, T], "y":
[N]}``.

Its default optimizer is the reference's ``optax.adamw(2e-5)``:
``torch.optim.AdamW(lr=2e-5, weight_decay=1e-4)`` over every parameter
(optax's default decay is 1e-4, torch's 1e-2; optax masks no
parameter there).  ``TextEstimator`` defaults to Adam at 1e-3, as the
reference's ``optax.adam(1e-3)``.

Not ported yet (ROADMAP Queue 1 item 8): ``TextSet`` inputs (pass a
dict of numpy arrays), and the other estimators of the module
(``TextClassificationEstimator``, ``KNRMEstimator``, ``NEREstimator``,
``POSEstimator``, ``IntentEntityEstimator``), which raise.  Partition
rules (tensor parallelism) are item 6.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from analytics_zoo_tpu_torch.learn.estimator import TorchEstimator


def _text_arrays(data):
    """A dict of numpy arrays passes through; text containers raise."""
    if data is None or isinstance(data, dict):
        return data
    raise NotImplementedError(
        f"{type(data).__name__} inputs are not ported yet (ROADMAP Queue 1 "
        f"item 8: TextSet); pass a dict of numpy arrays")


def _adamw_2e5(params):
    """``optax.adamw(2e-5)``: b1 0.9, b2 0.999, eps 1e-8, decoupled
    weight decay 1e-4 on every parameter."""
    return torch.optim.AdamW(params, lr=2e-5, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


class TextEstimator:
    """Base text estimator: a torch model and its column mapping on the
    port's Estimator.  ``optimizer`` is what ``Estimator.from_torch``
    takes (a learning rate for Adam, or ``params -> Optimizer``),
    Adam at 1e-3 by default; ``**kw`` goes to the Estimator
    (``config``, ``device``)."""

    def __init__(self, model, loss, optimizer=None, *,
                 feature_cols: Sequence[str] = ("tokens",),
                 label_cols: Sequence[str] = ("y",),
                 metrics: Sequence = ("accuracy",), **kw):
        if "partition_rules" in kw:
            raise NotImplementedError(
                "partition_rules (tensor parallelism) are not ported yet "
                "(ROADMAP Queue 1 item 6)")
        self.estimator = TorchEstimator(
            model, loss, optimizer if optimizer is not None else 1e-3,
            feature_cols=feature_cols, label_cols=label_cols,
            metrics=metrics, **kw)

    @property
    def model(self):
        return self.estimator.model

    def fit(self, data, epochs: int = 1, batch_size: int = 32,
            validation_data=None, **kw):
        return self.estimator.fit(
            _text_arrays(data), epochs=epochs, batch_size=batch_size,
            validation_data=_text_arrays(validation_data), **kw)

    def evaluate(self, data, batch_size: int = 32, **kw):
        return self.estimator.evaluate(_text_arrays(data),
                                       batch_size=batch_size, **kw)

    def predict(self, data, batch_size: int = 32, **kw):
        return self.estimator.predict(_text_arrays(data),
                                      batch_size=batch_size, **kw)

    def save_checkpoint(self, path: str):
        return self.estimator.save_checkpoint(path)

    def load_checkpoint(self, path: str, step: Optional[int] = None):
        return self.estimator.load_checkpoint(path, step)

    def save(self, path: str):
        return self.estimator.save(path)

    def load(self, path: str, sample_data=None):
        return self.estimator.load(path, _text_arrays(sample_data))


class BERTClassifier(TextEstimator):
    """Sequence classification over the BERT encoder: the reference's
    ``BERTClassifier``.  ``bert`` defaults to BERT-base; the loss is
    sparse categorical cross-entropy on ``y`` and the features are
    ``input_ids`` alone, as in the reference (train a masked or
    two-segment BERT through ``Estimator.from_torch`` or
    ``frames.NNClassifier`` with more feature columns)."""

    def __init__(self, num_classes: int, *, bert=None, optimizer=None,
                 **kw):
        from analytics_zoo_tpu_torch.models.transformer import (
            BERTForSequenceClassification)

        super().__init__(
            BERTForSequenceClassification(num_classes=num_classes,
                                          bert=bert),
            "sparse_categorical_crossentropy",
            optimizer if optimizer is not None else _adamw_2e5,
            feature_cols=("input_ids",), label_cols=("y",), **kw)


def _not_ported(name: str):
    class _Later(TextEstimator):
        def __init__(self, *args, **kw):
            raise NotImplementedError(
                f"{name} is not ported yet (ROADMAP Queue 1 item 8: the "
                f"text models)")

    _Later.__name__ = _Later.__qualname__ = name
    _Later.__doc__ = (f"The reference's ``{name}``; raises until ROADMAP "
                      f"Queue 1 item 8 ports its model.")
    return _Later


TextClassificationEstimator = _not_ported("TextClassificationEstimator")
KNRMEstimator = _not_ported("KNRMEstimator")
NEREstimator = _not_ported("NEREstimator")
POSEstimator = _not_ported("POSEstimator")
IntentEntityEstimator = _not_ported("IntentEntityEstimator")

__all__ = [
    "TextEstimator", "TextClassificationEstimator", "KNRMEstimator",
    "BERTClassifier", "NEREstimator", "POSEstimator",
    "IntentEntityEstimator",
]
