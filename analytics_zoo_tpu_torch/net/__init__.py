"""Net: import a model from another format.

The port of ``analytics_zoo_tpu/net/__init__.py``.  ``Net.load_torch``
takes an ``nn.Module`` or a path ``torch.load`` reads and returns the
module itself: a torch module is the port's own form, so the
reference's torch.fx conversion (``net/torch_net.py``) has no
counterpart.  ``Net.load_openvino`` reads an OpenVINO IR
(``net/openvino_ir.py``) and the ``load_hf_*`` loaders import
HuggingFace checkpoints (``net/hf_net.py``).  ``load_tf`` and
``load_keras`` (TensorFlow's SavedModel and Keras files, the
reference's ``net/tf_net.py``) are not ported: they raise
``NotImplementedError``.
"""

from __future__ import annotations

import os
import re

from analytics_zoo_tpu_torch.net.openvino_ir import OpenVINONet

# gs://, hdfs://, s3://, ...: os.path.exists would falsely reject them
_REMOTE_SCHEME = re.compile(r"^[A-Za-z][A-Za-z0-9+.-]*://")


def _is_local_path(p: str) -> bool:
    return not _REMOTE_SCHEME.match(p)


def _tf_later(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP Queue 1 item 4: item 9's "
        f"TensorFlow importer, net/tf_net.py)")


class Net:
    """The reference's constructor facade for importing models."""

    @staticmethod
    def load_torch(module_or_path):
        """A torch ``nn.Module``, or a path to one that ``torch.load``
        reads (a pickled module), returned as it is."""
        import torch

        m = module_or_path
        if isinstance(m, (str, bytes, os.PathLike)):
            m = torch.load(m, weights_only=False, map_location="cpu")
        if not isinstance(m, torch.nn.Module):
            raise TypeError(f"expected nn.Module or path, got {type(m)}")
        return m

    @staticmethod
    def load_keras(model):
        raise _tf_later("Net.load_keras")

    @staticmethod
    def load_tf(path_or_fn, signature: str = "serving_default"):
        raise _tf_later("Net.load_tf")

    @staticmethod
    def load_openvino(xml_path, bin_path=None) -> OpenVINONet:
        """An OpenVINO IR (``.xml`` + ``.bin``) as an
        :class:`OpenVINONet`.  Forward-only."""
        p = os.fspath(xml_path)
        if _is_local_path(p) and not os.path.exists(p):
            raise FileNotFoundError(f"no such IR xml: {p!r}")
        return OpenVINONet.from_ir(p, bin_path)

    @staticmethod
    def load_hf_gpt2(model_or_path, dtype=None):
        """A HuggingFace GPT-2 -> ``(TransformerLM, variables)``."""
        from analytics_zoo_tpu_torch.net.hf_net import from_hf_gpt2

        return from_hf_gpt2(model_or_path, dtype=dtype)

    @staticmethod
    def load_hf_llama(model_or_path, dtype=None):
        """A HuggingFace Llama -> ``(TransformerLM, variables)``."""
        from analytics_zoo_tpu_torch.net.hf_net import from_hf_llama

        return from_hf_llama(model_or_path, dtype=dtype)

    @staticmethod
    def load_hf_mistral(model_or_path, dtype=None):
        """A HuggingFace Mistral (not windowed) -> ``(TransformerLM,
        variables)``."""
        from analytics_zoo_tpu_torch.net.hf_net import from_hf_mistral

        return from_hf_mistral(model_or_path, dtype=dtype)

    @staticmethod
    def load_hf_qwen2(model_or_path, dtype=None):
        """A HuggingFace Qwen2 -> ``(TransformerLM, variables)``."""
        from analytics_zoo_tpu_torch.net.hf_net import from_hf_qwen2

        return from_hf_qwen2(model_or_path, dtype=dtype)


__all__ = ["OpenVINONet", "Net"]
