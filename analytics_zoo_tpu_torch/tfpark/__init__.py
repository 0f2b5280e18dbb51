"""The port's ``tfpark``: the reference's namespace for the TF1 training
suite (``analytics_zoo_tpu/tfpark/__init__.py``), backed by the port.

- ``TFEstimator``: the port's ``learn.Estimator`` (``from_torch``);
- ``TFPredictor``: ``learn.InferenceModel``;
- ``GANEstimator``: ``tfpark.gan``; ``TFDataset``: ``tfpark.tf_dataset``;
- ``text``: the NLP estimators (``tfpark.text``);
- ``KerasModel``: wraps the Keras-style API's models, which are not
  ported yet (ROADMAP Queue 1 item 8.4's Keras part); it raises.
"""

from analytics_zoo_tpu_torch.learn.estimator import Estimator as TFEstimator
from analytics_zoo_tpu_torch.learn.inference_model import (
    InferenceModel as TFPredictor)
from analytics_zoo_tpu_torch.tfpark.gan import GANEstimator
from analytics_zoo_tpu_torch.tfpark.tf_dataset import TFDataset
from analytics_zoo_tpu_torch.tfpark import text  # noqa: F401 (NLP estimators)


def KerasModel(model):
    """The reference's ``tfpark.KerasModel`` returns a model of its
    Keras-style API; that API (``keras/``, ``autograd.py``) is not
    ported yet."""
    raise NotImplementedError(
        "tfpark.KerasModel wraps the Keras-style API (keras/, "
        "autograd.py), which is not ported yet (ROADMAP Queue 1 item "
        "8.4, its Keras part)")


__all__ = ["TFEstimator", "TFPredictor", "KerasModel", "GANEstimator",
           "TFDataset", "text"]
