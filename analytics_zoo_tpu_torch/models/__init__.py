"""The port's model zoo.  Each module is the port of its namesake in
``analytics_zoo_tpu/models``; the image classification, text, anomaly,
seq2seq and detection names are exported here, as the reference's
``models`` package exports them."""

from analytics_zoo_tpu_torch.models.anomaly import (AnomalyDetector,
                                                    detect_anomalies, unroll)
from analytics_zoo_tpu_torch.models.detection import (SSD, SSDDetector,
                                                      decode_detections,
                                                      multibox_loss,
                                                      ssd_anchors)
from analytics_zoo_tpu_torch.models.image import (ImageClassifier, ResNet,
                                                  SimpleCNN, resnet18,
                                                  resnet34, resnet50)
from analytics_zoo_tpu_torch.models.seq2seq import Seq2Seq, greedy_generate
from analytics_zoo_tpu_torch.models.text import KNRM, TextClassifier

__all__ = ["TextClassifier", "KNRM",
           "AnomalyDetector", "unroll", "detect_anomalies",
           "Seq2Seq", "greedy_generate",
           "ResNet", "SimpleCNN", "ImageClassifier", "resnet18", "resnet34",
           "resnet50",
           "SSD", "SSDDetector", "ssd_anchors", "multibox_loss",
           "decode_detections"]
