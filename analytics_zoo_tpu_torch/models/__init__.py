"""The port's model zoo.  Each module is the port of its namesake in
``analytics_zoo_tpu/models``; the image classification names are
exported here, as the reference's ``models`` package exports them."""

from analytics_zoo_tpu_torch.models.image import (ImageClassifier, ResNet,
                                                  SimpleCNN, resnet18,
                                                  resnet34, resnet50)

__all__ = ["ResNet", "SimpleCNN", "ImageClassifier", "resnet18", "resnet34",
           "resnet50"]
