"""The port's ``tfpark``: the reference's namespace for the TF1 training
suite (``analytics_zoo_tpu/tfpark/__init__.py``), backed by the port.

- ``TFEstimator``: the port's ``learn.Estimator`` (``from_torch``);
- ``TFPredictor``: ``learn.InferenceModel``;
- ``GANEstimator``: ``tfpark.gan``; ``TFDataset``: ``tfpark.tf_dataset``;
- ``text``: the NLP estimators (``tfpark.text``);
- ``KerasModel``: the Keras-style API's models (``keras/``), which
  already carry compile/fit/evaluate/predict: it returns one unchanged
  and raises ``TypeError`` for anything else, as the reference does.
"""

from analytics_zoo_tpu_torch.learn.estimator import Estimator as TFEstimator
from analytics_zoo_tpu_torch.learn.inference_model import (
    InferenceModel as TFPredictor)
from analytics_zoo_tpu_torch.tfpark.gan import GANEstimator
from analytics_zoo_tpu_torch.tfpark.tf_dataset import TFDataset
from analytics_zoo_tpu_torch.tfpark import text  # noqa: F401 (NLP estimators)


def KerasModel(model):
    """ref-parity: ``tfpark.KerasModel`` wrapped a compiled tf.keras
    model; the port's Keras models already carry compile/fit/evaluate/
    predict."""
    from analytics_zoo_tpu_torch.keras.engine import KerasNet

    if not isinstance(model, KerasNet):
        raise TypeError(
            f"KerasModel wraps analytics_zoo_tpu_torch.keras models, got "
            f"{type(model).__name__}")
    return model


__all__ = ["TFEstimator", "TFPredictor", "KerasModel", "GANEstimator",
           "TFDataset", "text"]
