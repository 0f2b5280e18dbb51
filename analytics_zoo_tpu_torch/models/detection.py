"""Object detection: SSD over a ResNet feature pyramid, the port of
``analytics_zoo_tpu/models/detection.py``.

- :class:`SSD`: the port's ``ResNet(return_features=True)`` (NHWC in,
  NCHW in ``channels_last`` inside) and, at each pyramid level, a 3x3
  ``head<l>_conv`` (128 channels, in ``dtype``) with ReLU, then 3x3
  ``head<l>_loc`` and ``head<l>_cls`` convolutions in f32.  The heads'
  ``[B, A*4, H, W]`` outputs are permuted to NHWC before the reshape to
  ``[B, H*W*A, 4]``, so anchors run (row, col, aspect) as
  :func:`ssd_anchors` lays them out; an ``image_size`` that 32 does not
  divide gets the ceil grids of flax's SAME convolutions.
- :func:`multibox_loss`: matching, encoding and 3:1 hard-negative mining
  for the whole batch at once (:func:`match_targets`).  Every anchor
  takes its best box by IoU (the first on ties), positive at
  ``iou_thresh``; every valid box also claims its best anchor.  Where
  two boxes claim one anchor the reference's scatter keeps the last
  write, the box of the highest index; here that is a ``scatter_reduce``
  ``amax`` over the box index, the same on every device and run
  (``index_put_`` with duplicate indices is not deterministic on CUDA).
  Padding rows (class -1) route to an index past the anchors and are
  dropped.  Negatives rank by a stable double argsort of their
  cross-entropy (positives at -inf); the loss is the mean over images of
  ``(cls + loc) / max(n_pos, 1)``, ``loc`` the Huber loss (delta 1)
  summed over the 4 offsets of the positives.
- The host half, numpy copies of the reference's and pinned to it by
  ``tests/test_torch_serving_pins.py``: :func:`ssd_anchors`,
  ``_decode_boxes``, ``_nms`` and :func:`decode_detections`.
- :class:`SSDDetector`: ``SSD`` on ``Estimator.from_torch`` with
  ``label_cols=("boxes", "classes")``, Adam at 1e-3 by default; ``fit``,
  ``detect`` (``predict`` then ``decode_detections``), ``save``, ``load``.
  It runs on ``device`` (``cuda`` unless the caller names another).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.models.image import ResNet
from analytics_zoo_tpu_torch.models.layers import Conv2d, conv2d

# anchor aspect ratios per cell (w/h); one scale per pyramid level
DEFAULT_ASPECTS = (1.0, 2.0, 0.5)


# ---------------------------------------------------------------------------
# anchors
# ---------------------------------------------------------------------------

def ssd_anchors(image_size: int, strides: Sequence[int],
                scales: Sequence[float],
                aspects: Sequence[float] = DEFAULT_ASPECTS) -> np.ndarray:
    """Anchor grid [N, 4] as (cy, cx, h, w), normalised to [0, 1].

    Level k tiles `image_size/strides[k]` cells; each cell holds
    len(aspects) anchors of area scales[k]^2 (scales are fractions of the
    image side).  Matches the head layout in SSD.__call__ exactly:
    anchors iterate (row, col, aspect), levels concatenated in order.
    """
    if len(strides) != len(scales):
        raise ValueError("strides and scales must align per level")
    out = []
    for stride, scale in zip(strides, scales):
        # ceil-div: SAME-padded stride-2 convs produce ceil(in/2) per
        # downsample, and iterated ceil-halving equals ceil(n / 2^k) — so
        # this matches the head grid for ANY image size, not just
        # multiples of the deepest stride
        fm = -(-image_size // stride)
        cy, cx = np.meshgrid(
            (np.arange(fm) + 0.5) / fm, (np.arange(fm) + 0.5) / fm,
            indexing="ij")
        for ar in aspects:
            h = scale / np.sqrt(ar)
            w = scale * np.sqrt(ar)
            lvl = np.stack([cy, cx, np.full_like(cy, h),
                            np.full_like(cx, w)], axis=-1)
            out.append(lvl.reshape(-1, 4))
        # interleave aspects per cell: reorder so the fastest axis is the
        # aspect (head emits [H, W, A*4])
    per_level = []
    i = 0
    for stride in strides:
        fm = -(-image_size // stride)
        cells = fm * fm
        block = np.stack(out[i:i + len(aspects)], axis=1)  # [cells, A, 4]
        per_level.append(block.reshape(-1, 4))
        i += len(aspects)
    return np.concatenate(per_level).astype(np.float32)


def _encode_boxes(anchors: torch.Tensor, boxes: torch.Tensor
                  ) -> torch.Tensor:
    """(ymin,xmin,ymax,xmax) gt vs (cy,cx,h,w) anchors -> regression
    targets (dy, dx, log dh, log dw)."""
    b_cy = (boxes[..., 0] + boxes[..., 2]) / 2
    b_cx = (boxes[..., 1] + boxes[..., 3]) / 2
    b_h = torch.clamp(boxes[..., 2] - boxes[..., 0], min=1e-6)
    b_w = torch.clamp(boxes[..., 3] - boxes[..., 1], min=1e-6)
    return torch.stack([
        (b_cy - anchors[..., 0]) / anchors[..., 2],
        (b_cx - anchors[..., 1]) / anchors[..., 3],
        torch.log(b_h / anchors[..., 2]),
        torch.log(b_w / anchors[..., 3]),
    ], dim=-1)


def _decode_boxes(anchors: np.ndarray, deltas: np.ndarray) -> np.ndarray:
    cy = deltas[..., 0] * anchors[..., 2] + anchors[..., 0]
    cx = deltas[..., 1] * anchors[..., 3] + anchors[..., 1]
    h = np.exp(deltas[..., 2]) * anchors[..., 2]
    w = np.exp(deltas[..., 3]) * anchors[..., 3]
    return np.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2],
                    axis=-1)


def _iou_matrix(anchors_yx: torch.Tensor, boxes: torch.Tensor
                ) -> torch.Tensor:
    """IoU ``[..., N_anchors, M_boxes]`` of anchors ``[N, 4]`` and boxes
    ``[..., M, 4]``; both as (ymin,xmin,ymax,xmax)."""
    a = anchors_yx[:, None, :]
    b = boxes[..., None, :, :]
    inter_h = torch.clamp(torch.minimum(a[..., 2], b[..., 2]) -
                          torch.maximum(a[..., 0], b[..., 0]), min=0)
    inter_w = torch.clamp(torch.minimum(a[..., 3], b[..., 3]) -
                          torch.maximum(a[..., 1], b[..., 1]), min=0)
    inter = inter_h * inter_w
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = torch.clamp((b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1]),
                         min=0)
    return inter / torch.clamp(area_a + area_b - inter, min=1e-9)


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

class SSD(nn.Module):
    """SSD heads over a ResNet pyramid.

    Inputs ``[B, S, S, 3]`` (S = image_size); outputs ``(loc [B, N, 4],
    cls_logits [B, N, num_classes+1])`` with class 0 = background."""

    def __init__(self, num_classes: int, image_size: int = 256,
                 backbone_width: int = 64,
                 backbone_stages: Sequence[int] = (2, 2, 2, 2),
                 levels: Sequence[int] = (1, 2, 3),
                 scales: Sequence[float] = (0.15, 0.35, 0.6),
                 aspects: Sequence[float] = DEFAULT_ASPECTS,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_classes, self.image_size = num_classes, image_size
        self.levels, self.scales = tuple(levels), tuple(scales)
        self.aspects, self.dtype = tuple(aspects), dtype
        self.backbone = ResNet(1, stage_sizes=tuple(backbone_stages),
                               width=backbone_width, return_features=True,
                               dtype=dtype)
        A = len(self.aspects)
        for li, s in enumerate(self.levels):
            setattr(self, f"head{li}_conv",
                    Conv2d(backbone_width * 2 ** s, 128, 3, bias=True))
            setattr(self, f"head{li}_loc", Conv2d(128, A * 4, 3, bias=True))
            setattr(self, f"head{li}_cls",
                    Conv2d(128, A * (num_classes + 1), 3, bias=True))

    def strides(self) -> List[int]:
        return [4 * (2 ** s) for s in self.levels]

    def anchors(self) -> np.ndarray:
        return ssd_anchors(self.image_size, self.strides(),
                           list(self.scales), list(self.aspects))

    def forward(self, x, train: bool = False):
        if x.shape[1] != self.image_size or x.shape[2] != self.image_size:
            raise ValueError(
                f"SSD(image_size={self.image_size}) got {tuple(x.shape)}")
        feats = self.backbone(x, train)
        B = x.shape[0]
        locs, clss = [], []
        # the loc and cls convolutions in f32 (f64 stays f64)
        head_dt = torch.promote_types(self.dtype, torch.float32)
        for li, s in enumerate(self.levels):
            f = feats[s].permute(0, 3, 1, 2)          # NCHW, channels_last
            h = torch.relu(conv2d(getattr(self, f"head{li}_conv"), f,
                                  self.dtype))
            loc = conv2d(getattr(self, f"head{li}_loc"), h, head_dt)
            cls = conv2d(getattr(self, f"head{li}_cls"), h, head_dt)
            # NHWC order before the reshape: (row, col, aspect)
            locs.append(loc.permute(0, 2, 3, 1).reshape(B, -1, 4))
            clss.append(cls.permute(0, 2, 3, 1).reshape(
                B, -1, self.num_classes + 1))
        return torch.cat(locs, 1), torch.cat(clss, 1)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def _corners(anc: torch.Tensor) -> torch.Tensor:
    return torch.stack([anc[:, 0] - anc[:, 2] / 2, anc[:, 1] - anc[:, 3] / 2,
                        anc[:, 0] + anc[:, 2] / 2, anc[:, 1] + anc[:, 3] / 2],
                       dim=-1)


def match_targets(anchors, boxes: torch.Tensor, classes: torch.Tensor,
                  iou_thresh: float = 0.5
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every anchor's match for a batch: ``(pos [B, N] bool, tgt_cls [B,
    N] (0 = background), tgt_loc [B, N, 4])`` from ``boxes [B, M, 4]``
    and ``classes [B, M]`` (-1 pads).  Deterministic on every device."""
    anc = torch.as_tensor(np.asarray(anchors, np.float32)
                          if not isinstance(anchors, torch.Tensor)
                          else anchors, device=boxes.device)
    N, M = anc.shape[0], boxes.shape[1]
    boxes = boxes.float()
    classes = classes.long()
    valid = classes >= 0                                       # [B, M]
    iou = _iou_matrix(_corners(anc), boxes)                    # [B, N, M]
    iou = torch.where(valid[:, None, :], iou, torch.full_like(iou, -1.0))
    best_iou = iou.amax(dim=2)                                 # [B, N]
    best_box = iou.argmax(dim=2)                               # [B, N]
    pos = best_iou >= iou_thresh
    # every valid box also claims its best anchor; padding rows go to
    # column N, which is dropped.  Where boxes share an anchor the
    # highest box index wins (the reference's scatter keeps the last
    # write); amax over integers is order-free, so it is deterministic.
    best_anchor = iou.argmax(dim=1)                            # [B, M]
    safe = torch.where(valid, best_anchor, torch.full_like(best_anchor, N))
    box_ids = torch.arange(M, device=boxes.device).expand_as(safe)
    claim = torch.full((boxes.shape[0], N + 1), -1, dtype=torch.long,
                       device=boxes.device)
    claim = claim.scatter_reduce(1, safe, box_ids, reduce="amax",
                                 include_self=True)[:, :N]
    claimed = claim >= 0
    pos = pos | claimed
    best_box = torch.where(claimed, claim, best_box)
    matched_cls = torch.gather(classes, 1, best_box)
    tgt_cls = torch.where(pos, matched_cls + 1, torch.zeros_like(matched_cls))
    matched = torch.gather(boxes, 1, best_box[..., None].expand(-1, -1, 4))
    return pos, tgt_cls, _encode_boxes(anc, matched)


def multibox_loss(anchors: np.ndarray, num_classes: int,
                  neg_pos_ratio: int = 3, iou_thresh: float = 0.5):
    """Returns an Estimator-compatible loss ``fn(preds, labels)``.

    labels = (boxes [B, M, 4] in (ymin,xmin,ymax,xmax) normalised,
    classes [B, M] int with -1 padding)."""
    anchors = np.asarray(anchors, np.float32)

    def loss_fn(preds, labels):
        loc, cls_logits = preds
        boxes, classes = labels
        pos, tgt_cls, tgt_loc = match_targets(anchors, boxes, classes,
                                              iou_thresh)
        B, N = pos.shape
        # f32 (f64 stays f64), as the reference's f32 loss
        dt = torch.promote_types(cls_logits.dtype, torch.float32)
        ce = F.cross_entropy(cls_logits.to(dt).reshape(B * N, -1),
                             tgt_cls.reshape(-1),
                             reduction="none").reshape(B, N)
        n_pos = torch.clamp(pos.sum(dim=1), min=1)             # [B]
        # hard negative mining: the ratio * n_pos hardest negatives
        neg_ce = torch.where(pos, torch.full_like(ce, float("-inf")), ce)
        rank = torch.argsort(torch.argsort(-neg_ce, dim=1, stable=True),
                             dim=1, stable=True)               # 0: hardest
        neg = (~pos) & (rank < neg_pos_ratio * n_pos[:, None])
        zero = torch.zeros_like(ce)
        cls_loss = torch.where(pos | neg, ce, zero).sum(1) / n_pos
        huber = F.huber_loss(loc.to(dt), tgt_loc.to(dt), reduction="none",
                             delta=1.0).sum(-1)
        loc_loss = torch.where(pos, huber, zero).sum(1) / n_pos
        return (cls_loss + loc_loss).mean()

    return loss_fn


# ---------------------------------------------------------------------------
# decode (host)
# ---------------------------------------------------------------------------

def _nms(boxes: np.ndarray, scores: np.ndarray, iou_thresh: float,
         top_k: int) -> List[int]:
    order = np.argsort(-scores)[:top_k * 4]
    keep: List[int] = []
    while order.size and len(keep) < top_k:
        i = order[0]
        keep.append(int(i))
        if order.size == 1:
            break
        rest = order[1:]
        yx1 = np.maximum(boxes[i, :2], boxes[rest, :2])
        yx2 = np.minimum(boxes[i, 2:], boxes[rest, 2:])
        wh = np.clip(yx2 - yx1, 0, None)
        inter = wh[:, 0] * wh[:, 1]
        area_i = np.prod(boxes[i, 2:] - boxes[i, :2])
        area_r = np.prod(boxes[rest, 2:] - boxes[rest, :2], axis=1)
        iou = inter / np.maximum(area_i + area_r - inter, 1e-9)
        order = rest[iou <= iou_thresh]
    return keep


def decode_detections(loc: np.ndarray, cls_logits: np.ndarray,
                      anchors: np.ndarray, *, score_thresh: float = 0.5,
                      iou_thresh: float = 0.45, top_k: int = 100
                      ) -> List[dict]:
    """Raw head outputs -> per-image detections.

    Returns one dict per image: {"boxes" [K,4] (ymin,xmin,ymax,xmax in
    [0,1]), "scores" [K], "classes" [K] (0-based foreground ids)}.
    (ref: object-detection `Predictor` + `decode_output` chain.)
    """
    loc = np.asarray(loc)
    cls_logits = np.asarray(cls_logits)
    e = np.exp(cls_logits - cls_logits.max(-1, keepdims=True))
    probs = e / e.sum(-1, keepdims=True)
    out = []
    for b in range(loc.shape[0]):
        boxes = _decode_boxes(anchors, loc[b])
        fg = probs[b, :, 1:]                       # drop background
        cls_id = fg.argmax(-1)
        score = fg.max(-1)
        m = score >= score_thresh
        bx, sc, ci = boxes[m], score[m], cls_id[m]
        final_b, final_s, final_c = [], [], []
        for c in np.unique(ci):                    # per-class NMS
            sel = np.flatnonzero(ci == c)
            kept = _nms(bx[sel], sc[sel], iou_thresh, top_k)
            final_b.append(bx[sel[kept]])
            final_s.append(sc[sel[kept]])
            final_c.append(np.full(len(kept), c))
        if final_b:
            bx = np.concatenate(final_b)
            sc = np.concatenate(final_s)
            ci = np.concatenate(final_c)
            order = np.argsort(-sc)[:top_k]
            bx, sc, ci = bx[order], sc[order], ci[order]
        else:
            bx = np.zeros((0, 4), np.float32)
            sc = np.zeros((0,), np.float32)
            ci = np.zeros((0,), np.int64)
        out.append({"boxes": np.clip(bx, 0, 1), "scores": sc,
                    "classes": ci})
    return out


# ---------------------------------------------------------------------------
# user-facing wrapper (ref: ObjectDetector load/predict surface)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SSDDetector:
    """Train/predict convenience over (SSD model + Estimator).

    ``fit(data)`` expects columns {"x" images, "boxes" [B,M,4],
    "classes" [B,M] (-1 padded)}; ``detect(images)`` returns decoded
    per-image detections.  ``optimizer`` is what ``Estimator.from_torch``
    takes (Adam at 1e-3 by default); ``device`` where it runs (``cuda``
    unless the caller names another), ``config`` a ``TrainConfig``."""

    num_classes: int
    image_size: int = 256
    backbone_width: int = 64
    max_boxes: int = 8
    optimizer: object = None
    score_thresh: float = 0.5
    device: object = None
    config: object = None

    def __post_init__(self):
        from analytics_zoo_tpu_torch.learn import Estimator

        self.model = SSD(num_classes=self.num_classes,
                         image_size=self.image_size,
                         backbone_width=self.backbone_width)
        self.anchors = self.model.anchors()
        self.estimator = Estimator.from_torch(
            model=self.model,
            loss=multibox_loss(self.anchors, self.num_classes),
            optimizer=self.optimizer or 1e-3,
            feature_cols=("x",), label_cols=("boxes", "classes"),
            device=self.device, config=self.config)
        self.model = self.estimator.model

    def fit(self, data, epochs: int = 1, batch_size: int = 8, **kw):
        return self.estimator.fit(data, epochs=epochs,
                                  batch_size=batch_size, **kw)

    def detect(self, images, batch_size: int = 8, **decode_kw):
        loc, cls_logits = self.estimator.predict(
            {"x": np.asarray(images)}, batch_size=batch_size)
        decode_kw.setdefault("score_thresh", self.score_thresh)
        return decode_detections(loc, cls_logits, self.anchors,
                                 **decode_kw)

    def save(self, path: str):
        self.estimator.save(path)

    def load(self, path: str, sample_images=None):
        self.estimator.load(path, sample_images)


__all__ = ["SSD", "SSDDetector", "ssd_anchors", "multibox_loss",
           "decode_detections", "match_targets"]
