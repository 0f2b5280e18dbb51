"""ImageSet and the image transforms: a copy of
``analytics_zoo_tpu/data/image.py``.

Images decode on the host to RGB ``uint8`` HWC arrays through the native
data plane (libjpeg/libpng, the GIL released) or, where that fails or
was built without image support, through PIL.  The transforms
(``ImageResize`` through PIL, crops, flips, channel normalisation,
``ImageMatToTensor``) are numpy functions of one HWC array, chained
with ``>>``.  ``ImageSet`` holds (image, label, path) rows in
``XShards``; ``to_numpy_dict`` stacks them into ``{"x": [N, H, W, C]
f32, "y": [N]}`` for the Estimator, whose image models take NHWC.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from analytics_zoo_tpu_torch.data.shards import XShards
from analytics_zoo_tpu_torch.utils.transform import Chain, Transform

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".gif", ".webp")


# ---------------------------------------------------------------------------
# transforms (ref: ImageProcessing subclasses). Each is ndarray -> ndarray,
# image layout HWC float32 (or uint8 pre-normalize); chain with >>.
# ---------------------------------------------------------------------------

class ImageTransform(Transform):
    pass


class ChainedImageTransform(Chain, ImageTransform):
    pass


ImageTransform.chain_cls = ChainedImageTransform


def ImageResize(h: int, w: int) -> ImageTransform:
    def fn(img):
        from PIL import Image

        arr = np.asarray(img)
        pil = Image.fromarray(arr.astype(np.uint8) if arr.dtype != np.uint8
                              else arr)
        return np.asarray(pil.resize((w, h), Image.BILINEAR),
                          dtype=arr.dtype)
    return ImageTransform(fn, f"resize({h},{w})")


def ImageCenterCrop(h: int, w: int) -> ImageTransform:
    def fn(img):
        H, W = img.shape[:2]
        top, left = max(0, (H - h) // 2), max(0, (W - w) // 2)
        return img[top:top + h, left:left + w]
    return ImageTransform(fn, f"center_crop({h},{w})")


def ImageRandomCrop(h: int, w: int, seed: int = 0) -> ImageTransform:
    rng = np.random.default_rng(seed)

    def fn(img):
        H, W = img.shape[:2]
        top = int(rng.integers(0, max(1, H - h + 1)))
        left = int(rng.integers(0, max(1, W - w + 1)))
        return img[top:top + h, left:left + w]
    return ImageTransform(fn, f"random_crop({h},{w})")


def ImageHFlip(prob: float = 0.5, seed: int = 0) -> ImageTransform:
    rng = np.random.default_rng(seed)

    def fn(img):
        return img[:, ::-1] if rng.random() < prob else img
    return ImageTransform(fn, f"hflip({prob})")


def ImageChannelNormalize(*args) -> ImageTransform:
    """(mR,mG,mB[,sR,sG,sB]) — subtract means, divide stds (ref arg order)."""
    n = len(args) // 2 if len(args) >= 6 else len(args)
    means = np.asarray(args[:n], np.float32)
    stds = np.asarray(args[n:] or [1.0] * n, np.float32)

    def fn(img):
        return ((img.astype(np.float32) - means) / stds)
    return ImageTransform(fn, "channel_normalize")


def ImageMatToTensor(to_chw: bool = False) -> ImageTransform:
    """float32 conversion; TPU wants NHWC so to_chw defaults False
    (the reference's BigDL path wanted CHW)."""
    def fn(img):
        img = img.astype(np.float32)
        return img.transpose(2, 0, 1) if to_chw else img
    return ImageTransform(fn, "to_tensor")


# ---------------------------------------------------------------------------
# ImageSet
# ---------------------------------------------------------------------------

def _to_rgb(img: np.ndarray) -> np.ndarray:
    """Normalise any decoder output to 3-channel RGB.  The in-tree native
    decoder already requests RGB (JCS_RGB / PNG_FORMAT_RGB in
    dataplane.cpp), so this is a defensive shim for alternate builds:
    grayscale (1), gray+alpha (2) and RGBA (4) all map to RGB so batch
    shapes never depend on which decoder a host compiled in."""
    if img.ndim == 2:
        img = img[..., None]
    c = img.shape[-1]
    if c == 1:
        return np.repeat(img, 3, axis=-1)
    if c == 2:                      # gray + alpha: drop alpha, splat gray
        return np.repeat(img[..., :1], 3, axis=-1)
    if c == 4:
        return np.ascontiguousarray(img[..., :3])
    return img


def decode_image_bytes(raw) -> np.ndarray:
    """Encoded JPEG/PNG bytes -> RGB uint8 HWC (native C++ decode with the
    GIL released; PIL long-tail fallback). The bytes-input sibling of
    `_read_image` — serving and in-memory pipelines share it."""
    from analytics_zoo_tpu_torch import native

    try:
        return _to_rgb(native.decode_image(raw))
    except Exception:
        import io

        from PIL import Image

        with Image.open(io.BytesIO(raw)) as im:
            return np.asarray(im.convert("RGB"))


def _read_image(path: str) -> np.ndarray:
    """Decode one image to RGB uint8 HWC.

    Prefers the C++ data plane (libjpeg/libpng, GIL released — SURVEY §2.3
    native-decode obligation); PIL covers the long tail of formats (bmp,
    gif, webp, CMYK jpegs) and hosts whose .so was built without image
    support.  Remote URIs (gs://, s3://, memory://) fetch bytes through
    common.fs and share the bytes-input decode path."""
    from analytics_zoo_tpu_torch.common import fs

    if fs.is_remote(path):
        with fs.open(path, "rb") as f:
            return decode_image_bytes(f.read())
    from analytics_zoo_tpu_torch import native

    try:
        return _to_rgb(native.decode_image(path))
    except Exception:
        from PIL import Image

        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"))


def _read_images(paths: Sequence[str]) -> List[np.ndarray]:
    """Threaded decode: the native path releases the GIL per call, so a
    small pool gives near-linear speedup (the Spark-partition analog)."""
    if len(paths) < 4:
        return [_read_image(p) for p in paths]
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 4)) as ex:
        return list(ex.map(_read_image, paths))


class ImageSet:
    """A set of (image, label, path) triples backed by XShards.

    ref-parity constructors: ``read(path)`` (flat dir or one-subdir-per-
    class layout, which also yields labels), ``from_arrays``.
    """

    def __init__(self, shards: XShards,
                 class_names: Optional[List[str]] = None):
        self.shards = shards
        self.class_names = class_names

    @staticmethod
    def read(path: str, num_shards: int = 1,
             with_label: bool = False) -> "ImageSet":
        """Read images under `path` (local dir or remote gs://, s3://,
        memory:// URI). with_label: subdir name = class."""
        from analytics_zoo_tpu_torch.common import fs

        records: List[Tuple[str, int]] = []
        class_names: Optional[List[str]] = None
        if with_label:
            class_names = sorted(
                d for d in fs.listdir(path)
                if fs.isdir(fs.join(path, d)))
            for ci, cname in enumerate(class_names):
                cdir = fs.join(path, cname)
                for f in sorted(fs.listdir(cdir)):
                    if f.lower().endswith(IMAGE_EXTS):
                        records.append((fs.join(cdir, f), ci))
        else:
            for root, _, files in fs.walk(path):
                for f in sorted(files):
                    if f.lower().endswith(IMAGE_EXTS):
                        records.append((fs.join(root, f), -1))
        if not records:
            raise FileNotFoundError(f"no images under {path}")

        def load(recs):
            return {"image": _read_images([p for p, _ in recs]),
                    "label": np.asarray([l for _, l in recs], np.int32),
                    "path": [p for p, _ in recs]}

        shards = XShards.from_list(records, num_shards).transform_shard(load)
        return ImageSet(shards, class_names)

    @staticmethod
    def from_arrays(images: np.ndarray,
                    labels: Optional[np.ndarray] = None,
                    num_shards: int = 1) -> "ImageSet":
        labels = labels if labels is not None else \
            np.full(len(images), -1, np.int32)
        records = list(zip(list(images), np.asarray(labels)))

        def pack(recs):
            return {"image": [im for im, _ in recs],
                    "label": np.asarray([l for _, l in recs], np.int32),
                    "path": [""] * len(recs)}

        return ImageSet(
            XShards.from_list(records, num_shards).transform_shard(pack))

    def transform(self, t: ImageTransform) -> "ImageSet":
        def apply(shard):
            return {**shard, "image": [t(im) for im in shard["image"]]}
        return ImageSet(self.shards.transform_shard(apply),
                        self.class_names)

    def to_numpy_dict(self):
        """Stack into {'x': [N,H,W,C] f32, 'y': [N]} for the estimators.
        Requires uniform image shapes (apply Resize/Crop first)."""
        merged = {}
        for shard in self.shards.collect():
            for k, v in shard.items():
                merged.setdefault(k, []).extend(
                    v if isinstance(v, list) else list(v))
        x = np.stack(merged["image"]).astype(np.float32)
        return {"x": x, "y": np.asarray(merged["label"], np.int32)}

    def get_image(self) -> List[np.ndarray]:
        out = []
        for shard in self.shards.collect():
            out.extend(shard["image"])
        return out
