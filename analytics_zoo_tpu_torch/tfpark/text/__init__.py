"""tfpark.text: the NLP estimators of the port.

The port of ``analytics_zoo_tpu/tfpark/text/__init__.py``:
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

The text estimators take a ``TextSet`` (``data/text.py``), a ``(query,
doc)`` pair of them (the labels ride on the query side), a dict of
numpy arrays or an ``(x, y)`` pair, and bind the port's models:
``TextClassificationEstimator`` (``models.TextClassifier``),
``KNRMEstimator`` (``models.KNRM``: ``fit`` reshapes a ranking ``y`` to
``[B, 1]`` f32, ``evaluate`` and ``predict`` do not), ``NEREstimator``,
``POSEstimator`` and ``IntentEntityEstimator`` (``tfpark.text.keras``;
the taggers' metric is :func:`token_accuracy`, plain per-token accuracy,
padding included).  ``partition_rules=`` (and ``mesh=``) go to the
Estimator, which shards the model over a mesh's ``tp`` axis;
``BERTClassifier`` defaults to ``BERT_PARTITION_RULES``, as the
reference does, and on a mesh without ``tp`` (or with none) they
replicate.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from analytics_zoo_tpu_torch.data.text import TextSet
from analytics_zoo_tpu_torch.learn.estimator import TorchEstimator
from analytics_zoo_tpu_torch.tfpark.text import keras
from analytics_zoo_tpu_torch.tfpark.text.keras import (
    NER, POSTagger, IntentEntity, intent_entity_loss)


def _text_arrays(data) -> Dict[str, np.ndarray]:
    """TextSet / (TextSet, TextSet) pair / dict / (x, y) -> array dict."""
    if isinstance(data, TextSet):
        return data.to_numpy_dict()                  # {"tokens", "y"}
    if isinstance(data, (tuple, list)) and len(data) == 2 and \
            all(isinstance(t, TextSet) for t in data):
        a, b = (t.to_numpy_dict() for t in data)
        # matching pair: labels ride on the first set (the query side)
        return {"text1": a["tokens"], "text2": b["tokens"], "y": a["y"]}
    return data


def _adamw_2e5(params):
    """``optax.adamw(2e-5)``: b1 0.9, b2 0.999, eps 1e-8, decoupled
    weight decay 1e-4 on every parameter."""
    return torch.optim.AdamW(params, lr=2e-5, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


class TextEstimator:
    """Base text estimator: a torch model and its column mapping on the
    port's Estimator, taking text containers everywhere.  ``optimizer``
    is what ``Estimator.from_torch`` takes (a learning rate for Adam, or
    ``params -> Optimizer``), Adam at 1e-3 by default; ``**kw`` goes to
    the Estimator (``config``, ``device``).  ``batch_size=None`` takes
    the data container's own (a ``TFDataset``'s), else 32."""

    def __init__(self, model, loss, optimizer=None, *,
                 feature_cols: Sequence[str] = ("tokens",),
                 label_cols: Sequence[str] = ("y",),
                 metrics: Sequence = ("accuracy",), **kw):
        self.estimator = TorchEstimator(
            model, loss, optimizer if optimizer is not None else 1e-3,
            feature_cols=feature_cols, label_cols=label_cols,
            metrics=metrics, **kw)

    @property
    def model(self):
        return self.estimator.model

    def fit(self, data, epochs: int = 1, batch_size: Optional[int] = None,
            validation_data=None, **kw):
        if validation_data is not None:
            validation_data = _text_arrays(validation_data)
        return self.estimator.fit(
            _text_arrays(data), epochs=epochs, batch_size=batch_size,
            validation_data=validation_data, **kw)

    def evaluate(self, data, batch_size: Optional[int] = None, **kw):
        return self.estimator.evaluate(_text_arrays(data),
                                       batch_size=batch_size, **kw)

    def predict(self, data, batch_size: Optional[int] = None, **kw):
        return self.estimator.predict(_text_arrays(data),
                                      batch_size=batch_size, **kw)

    def save_checkpoint(self, path: str):
        return self.estimator.save_checkpoint(path)

    def load_checkpoint(self, path: str, step: Optional[int] = None):
        return self.estimator.load_checkpoint(path, step)

    def save(self, path: str):
        return self.estimator.save(path)

    def load(self, path: str, sample_data=None):
        if sample_data is not None:
            sample_data = _text_arrays(sample_data)
        return self.estimator.load(path, sample_data)


class TextClassificationEstimator(TextEstimator):
    """Text classification over ``models.TextClassifier`` (a CNN, LSTM or
    GRU token encoder and a softmax head)."""

    def __init__(self, class_num: int, vocab_size: int, *,
                 token_length: int = 200, sequence_length: int = 500,
                 encoder: str = "cnn", encoder_output_dim: int = 256,
                 embed_weights: Optional[np.ndarray] = None,
                 optimizer=None, **kw):
        from analytics_zoo_tpu_torch.models.text import TextClassifier

        super().__init__(
            TextClassifier(class_num=class_num, vocab_size=vocab_size,
                           token_length=token_length,
                           sequence_length=sequence_length,
                           encoder=encoder,
                           encoder_output_dim=encoder_output_dim,
                           embed_weights=embed_weights),
            "sparse_categorical_crossentropy", optimizer, **kw)


class KNRMEstimator(TextEstimator):
    """Kernel-pooled text matching over ``models.KNRM``.  Data:
    ``{"text1", "text2", "y"}`` arrays or a (query TextSet, doc TextSet)
    pair; ``target_mode="ranking"`` trains logistic relevance."""

    def __init__(self, vocab_size: int, *, text1_length: int = 10,
                 text2_length: int = 40, embed_dim: int = 300,
                 kernel_num: int = 21, sigma: float = 0.1,
                 exact_sigma: float = 0.001, target_mode: str = "ranking",
                 embed_weights: Optional[np.ndarray] = None,
                 optimizer=None, **kw):
        from analytics_zoo_tpu_torch.models.text import KNRM

        loss = "bce" if target_mode == "ranking" \
            else "sparse_categorical_crossentropy"
        metrics = kw.pop("metrics", ("binary_accuracy",)
                         if target_mode == "ranking" else ("accuracy",))
        super().__init__(
            KNRM(vocab_size=vocab_size, text1_length=text1_length,
                 text2_length=text2_length, embed_dim=embed_dim,
                 kernel_num=kernel_num, sigma=sigma,
                 exact_sigma=exact_sigma, target_mode=target_mode,
                 embed_weights=embed_weights),
            loss, optimizer,
            feature_cols=("text1", "text2"), metrics=metrics, **kw)

    def fit(self, data, epochs: int = 1, batch_size: Optional[int] = None,
            **kw):
        arrays = dict(_text_arrays(data))
        if "y" in arrays and self.model.target_mode == "ranking":
            # BCE against a [B, 1] score column
            arrays["y"] = np.asarray(arrays["y"],
                                     np.float32).reshape(-1, 1)
        return super().fit(arrays, epochs=epochs, batch_size=batch_size,
                           **kw)


class BERTClassifier(TextEstimator):
    """Sequence classification over the BERT encoder: the reference's
    ``BERTClassifier``.  ``bert`` defaults to BERT-base; the loss is
    sparse categorical cross-entropy on ``y`` and the features are
    ``input_ids`` alone, as in the reference (train a masked or
    two-segment BERT through ``Estimator.from_torch`` or
    ``frames.NNClassifier`` with more feature columns).
    ``partition_rules`` default to ``BERT_PARTITION_RULES``."""

    def __init__(self, num_classes: int, *, bert=None, optimizer=None,
                 **kw):
        from analytics_zoo_tpu_torch.models.transformer import (
            BERT_PARTITION_RULES, BERTForSequenceClassification)

        kw.setdefault("partition_rules", BERT_PARTITION_RULES)
        super().__init__(
            BERTForSequenceClassification(num_classes=num_classes,
                                          bert=bert),
            "sparse_categorical_crossentropy",
            optimizer if optimizer is not None else _adamw_2e5,
            feature_cols=("input_ids",), label_cols=("y",), **kw)


def token_accuracy(logits, labels):
    """Plain per-token accuracy, padding included: the pad id lives in
    the data, as in the reference's taggers."""
    return torch.mean(
        (torch.argmax(logits, -1) == labels.long()).float())


class NEREstimator(TextEstimator):
    """Sequence tagger estimator over ``tfpark.text.keras.NER``."""

    def __init__(self, num_entities: int, vocab_size: int, *,
                 embed_dim: int = 100, hidden: int = 100, optimizer=None,
                 **kw):
        kw.setdefault("metrics", (token_accuracy,))
        super().__init__(
            NER(vocab_size=vocab_size, embed_dim=embed_dim, hidden=hidden,
                num_entities=num_entities),
            "sparse_categorical_crossentropy", optimizer, **kw)


class POSEstimator(TextEstimator):
    """Sequence tagger estimator over ``tfpark.text.keras.POSTagger``."""

    def __init__(self, num_pos_tags: int, vocab_size: int, *,
                 embed_dim: int = 100, hidden: int = 100, optimizer=None,
                 **kw):
        kw.setdefault("metrics", (token_accuracy,))
        super().__init__(
            POSTagger(vocab_size=vocab_size, embed_dim=embed_dim,
                      hidden=hidden, num_pos_tags=num_pos_tags),
            "sparse_categorical_crossentropy", optimizer, **kw)


class IntentEntityEstimator(TextEstimator):
    """Joint intent + entity estimator over
    ``tfpark.text.keras.IntentEntity``.  Data columns: tokens, intent
    (an int a row), entity (an int a token)."""

    def __init__(self, num_intents: int, num_entities: int,
                 vocab_size: int, *, embed_dim: int = 100,
                 hidden: int = 100, optimizer=None, **kw):
        kw.setdefault("metrics", ())
        super().__init__(
            IntentEntity(vocab_size=vocab_size, embed_dim=embed_dim,
                         hidden=hidden, num_intents=num_intents,
                         num_entities=num_entities),
            intent_entity_loss, optimizer,
            label_cols=("intent", "entity"), **kw)


__all__ = [
    "TextEstimator", "TextClassificationEstimator", "KNRMEstimator",
    "BERTClassifier", "NEREstimator", "POSEstimator",
    "IntentEntityEstimator", "keras",
    "NER", "POSTagger", "IntentEntity",
]
