"""The port's host data plane against the JAX package's: images
(``data/image.py``, ``NNImageReader``), the Estimator's input kinds
(``DataCreator``), the native ring buffer, CSV parser, ZREC records and
``DiskFeatureSet`` (``native/``, ``data/feature_set.py``), the readers,
and ``/predict`` with encoded-image payloads.

Both packages decode with their own build of the same ``dataplane.cpp``
(or PIL), shuffle with the same seeds and pack the same bytes, so every
array is held exactly equal, apart from model outputs, which are held
to 1e-5 of their scale (f32, convs summed in another order).
"""

import base64
import http.client
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from analytics_zoo_tpu import native as jnative
from analytics_zoo_tpu.data import feature_set as jfs
from analytics_zoo_tpu.data import image as jimage
from analytics_zoo_tpu.data import readers as jreaders
from analytics_zoo_tpu.data.loader import DataCreator as JaxDataCreator
from analytics_zoo_tpu.data.shards import XShards as JaxXShards
from analytics_zoo_tpu.frames import NNImageReader as JaxNNImageReader
from analytics_zoo_tpu.learn.inference_model import \
    InferenceModel as JaxInferenceModel
from analytics_zoo_tpu.models.image import SimpleCNN as JaxSimpleCNN
from analytics_zoo_tpu.serving import ClusterServing as JaxServing
from analytics_zoo_tpu.serving import HttpFrontend as JaxFrontend
from analytics_zoo_tpu.serving import ServingConfig as JaxServingConfig
from analytics_zoo_tpu_torch import native
from analytics_zoo_tpu_torch.common.config import TrainConfig
from analytics_zoo_tpu_torch.data import feature_set as tfs
from analytics_zoo_tpu_torch.data import image as timage
from analytics_zoo_tpu_torch.data import readers
from analytics_zoo_tpu_torch.data.loader import DataCreator, device_prefetch
from analytics_zoo_tpu_torch.data.shards import XShards
from analytics_zoo_tpu_torch.frames import NNImageReader
from analytics_zoo_tpu_torch.learn import Estimator
from analytics_zoo_tpu_torch.learn.inference_model import InferenceModel
from analytics_zoo_tpu_torch.models.image import SimpleCNN
from analytics_zoo_tpu_torch.models.layers import params_from_flax
from analytics_zoo_tpu_torch.serving import (ClusterServing, HttpFrontend,
                                             ServingConfig)

_ATOL = 1e-5
_TIMEOUT = 90


def _png_jpeg_tree(root, with_classes):
    """A few RGB, grey and opaque RGBA images as PNG and JPEG, in class
    folders or flat; returns their paths."""
    rng = np.random.default_rng(0)
    paths = []
    for ci, cls in enumerate(("cat", "dog") if with_classes else ("",)):
        d = root / cls if cls else root
        d.mkdir(parents=True, exist_ok=True)
        for i, (mode, ext) in enumerate((("RGB", "png"), ("RGB", "jpg"),
                                         ("L", "png"), ("RGBA", "png"))):
            c = {"RGB": 3, "L": 1, "RGBA": 4}[mode]
            a = rng.integers(0, 256, (10 + i, 12, c)).astype(np.uint8)
            if c == 4:
                # opaque: the data plane composites a translucent pixel
                # onto uninitialised memory (ROADMAP Queue 3)
                a[..., 3] = 255
            img = Image.fromarray(a[..., 0] if c == 1 else a, mode)
            path = d / f"im{ci}{i}.{ext}"
            img.save(path)
            paths.append(path)
        (d / "notes.txt").write_text("not an image")
    return paths


def _same_dicts(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


@pytest.mark.parametrize("with_label", [False, True])
def test_imageset_read_matches_jax(tmp_path, with_label):
    _png_jpeg_tree(tmp_path, with_label)
    resize = (timage.ImageResize(8, 8), jimage.ImageResize(8, 8))
    got = timage.ImageSet.read(str(tmp_path), num_shards=2,
                               with_label=with_label)
    want = jimage.ImageSet.read(str(tmp_path), num_shards=2,
                                with_label=with_label)
    assert got.class_names == want.class_names
    for g, w in zip(got.get_image(), want.get_image()):
        assert g.dtype == np.uint8 and g.shape[-1] == 3
        np.testing.assert_array_equal(g, w)
    _same_dicts(got.transform(resize[0]).to_numpy_dict(),
                want.transform(resize[1]).to_numpy_dict())
    with pytest.raises(FileNotFoundError):
        timage.ImageSet.read(str(tmp_path / "cat" / "none"))


def test_transforms_match_jax():
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (20, 16, 3)).astype(np.uint8)
    for make in (lambda m: m.ImageResize(9, 7),
                 lambda m: m.ImageCenterCrop(10, 8),
                 lambda m: m.ImageRandomCrop(6, 6, seed=3),
                 lambda m: m.ImageHFlip(0.5, seed=4),
                 lambda m: m.ImageChannelNormalize(120, 110, 100, 50, 60, 70),
                 lambda m: m.ImageChannelNormalize(1.0, 2.0, 3.0),
                 lambda m: m.ImageMatToTensor(to_chw=True),
                 lambda m: m.ImageResize(12, 12) >> m.ImageCenterCrop(8, 8)
                 >> m.ImageChannelNormalize(0.5, 0.5, 0.5, 2, 2, 2)):
        t, j = make(timage), make(jimage)
        for _ in range(3):          # the seeded ones draw anew each call
            got, want = t(img), j(img)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    x = timage.ImageSet.from_arrays(np.stack([img] * 4), np.arange(4),
                                    num_shards=2)
    d = x.transform(timage.ImageMatToTensor()).to_numpy_dict()
    assert d["x"].shape == (4, 20, 16, 3) and d["y"].tolist() == [0, 1, 2, 3]


def test_decode_image_bytes_matches_jax(tmp_path):
    for path in _png_jpeg_tree(tmp_path, False):
        raw = path.read_bytes()
        np.testing.assert_array_equal(timage.decode_image_bytes(raw),
                                      jimage.decode_image_bytes(raw))
    assert native.image_available() == jnative.image_available()


@pytest.mark.parametrize("with_label", [False, True])
def test_nnimagereader_matches_jax(tmp_path, with_label):
    _png_jpeg_tree(tmp_path, with_label)
    kw = dict(resize_h=6, resize_w=5, with_label=with_label)
    got = NNImageReader.readImages(str(tmp_path), **kw)
    want = JaxNNImageReader.readImages(str(tmp_path), **kw)
    assert list(got.columns) == list(want.columns)
    assert got.attrs["class_names"] == want.attrs["class_names"]
    for c in got.columns:
        if c == "image":
            for g, w in zip(got[c], want[c]):
                np.testing.assert_array_equal(g, w)
        else:
            assert got[c].tolist() == want[c].tolist()
    assert got["height"].tolist() == [6] * len(got)


# ---------------------------------------------------------------------------
# the Estimator's inputs
# ---------------------------------------------------------------------------

def _xy(n=24, seed=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 6, 6, 1)).astype(np.float32),
            rng.integers(0, 3, n).astype(np.int32))


def _kinds(tmp_path, fs_mod, shards_cls):
    """Each input kind, built with one package's classes."""
    x, y = _xy()
    arrays = {"x": x, "y": y}
    path = str(tmp_path / f"{fs_mod.__name__}.zrec")
    return {
        "dict": arrays,
        "pair": (x, y),
        "pair_of_dicts": ({"x": x}, {"y": y}),
        "xshards": shards_cls.partition(arrays, 3),
        "feature_set": fs_mod.FeatureSet(arrays),
        "disk": fs_mod.FeatureSet(arrays).to_disk(path, block_rows=5),
        "creator": lambda config: arrays,
    }


def test_datacreator_matches_jax_for_each_kind(tmp_path):
    got = _kinds(tmp_path, tfs, XShards)
    want = _kinds(tmp_path, jfs, JaxXShards)
    for kind in got:
        _same_dicts(DataCreator.to_arrays(got[kind]),
                    JaxDataCreator.to_arrays(want[kind]))
    _same_dicts(DataCreator.to_arrays(got["dict"], feature_cols=["x"]),
                {"x": got["dict"]["x"]})
    with pytest.raises(KeyError, match="column 'z'"):
        DataCreator.to_arrays(got["dict"], label_cols=["z"])
    with pytest.raises(TypeError, match="unsupported"):
        DataCreator.to_arrays(3)


def test_estimator_takes_each_kind(tmp_path):
    """fit, evaluate and predict take every kind; the same rows give the
    same predictions, and a DiskFeatureSet streams its blocks."""
    kinds = _kinds(tmp_path, tfs, XShards)
    preds = {}
    for kind, data in kinds.items():
        torch.manual_seed(0)
        est = Estimator.from_torch(
            model=SimpleCNN(3, dtype=torch.float32),
            loss="sparse_categorical_crossentropy", optimizer=1e-3,
            config=TrainConfig(deterministic=True), device="cpu")
        hist = est.fit(data, epochs=1, batch_size=8)
        assert hist[0]["num_samples"] == 24.0, kind
        assert np.isfinite(est.evaluate(data, batch_size=7)["loss"])
        preds[kind] = est.predict(data, batch_size=7)
    for kind, p in preds.items():
        np.testing.assert_allclose(p, preds["dict"], atol=_ATOL, rtol=0,
                                   err_msg=kind)
    batches = list(device_prefetch(kinds["disk"].batches(
        8, shuffle=False, drop_remainder=False), "cpu"))
    assert [len(b["x"]) for b in batches] == [8, 8, 8]
    assert isinstance(batches[0]["x"], torch.Tensor)
    # a batch placement on a one-rank mesh hands the rank every row; a
    # sharding of another kind raises
    from analytics_zoo_tpu_torch.parallel import (data_sharding,
                                                  single_device_mesh)
    mesh = single_device_mesh(device="cpu")
    got = list(kinds["feature_set"].device_stream(
        mesh, 8, sharding=data_sharding(mesh), shuffle=False))
    assert [len(b["x"]) for b in got] == [8, 8, 8]
    with pytest.raises(TypeError, match="Placement"):
        next(kinds["feature_set"].device_stream("cpu", 8, sharding=object()))


# ---------------------------------------------------------------------------
# the native data plane
# ---------------------------------------------------------------------------

def test_ring_buffer_and_records_match_jax(tmp_path):
    items = [bytes([i]) * (i * 37 % 200 + 1) for i in range(40)]
    for mod in (native, jnative):
        rb = mod.RingBuffer(1 << 12)
        for it in items[:10]:
            assert rb.push(it)
        assert rb.depth() == 10
        assert rb.nbytes() == sum(map(len, items[:10]))
        assert [rb.pop() for _ in range(10)] == items[:10]
        rb.close()
        assert rb.pop() is None
        with pytest.raises(ValueError):
            mod.RingBuffer(capacity_bytes=10).push(b"x" * 64)
    batch = {"a": np.arange(12, dtype=np.int64).reshape(3, 4),
             "b": np.linspace(0, 1, 3, dtype=np.float32), "s": np.int32(7)}
    assert native.pack_batch(batch) == jnative.pack_batch(batch)
    _same_dicts(native.unpack_batch(jnative.pack_batch(batch)), batch)
    assert native.peek_batch_rows(native.pack_batch(batch)) == 3
    for w_mod, r_mod in ((native, jnative), (jnative, native)):
        path = str(tmp_path / f"{w_mod.__name__}.zrec")
        with w_mod.RecordWriter(path) as w:
            for it in items:
                w.write(it)
        with r_mod.RecordReader(path) as r:
            assert len(r) == len(items)
            assert [r.get_bytes(i) for i in range(len(r))] == items
            ring = r_mod.RingBuffer(1 << 14)
            order = [5, 1, 30, 2]
            pf = r_mod.Prefetcher(r, ring, order)
            assert [ring.pop(timeout=10) for _ in order] == \
                [items[i] for i in order]
            assert ring.pop(timeout=10) is None
            pf.stop()


def test_csv_and_readers_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    df = pd.DataFrame({"a": rng.integers(-5, 5, 50),
                       "b": rng.standard_normal(50),
                       "c": rng.integers(0, 1000, 50)})
    df.loc[3, "b"] = np.nan
    for i in range(3):
        df.iloc[i * 17:(i + 1) * 17].to_csv(tmp_path / f"p{i}.csv",
                                            index=False)
    one = str(tmp_path / "p0.csv")
    _same_dicts(native.read_csv_native(one), jnative.read_csv_native(one))
    for kw in ({}, {"backend": "pandas"}, {"usecols": ["a", "c"]}):
        got = readers.read_csv(str(tmp_path / "*.csv"), **kw)
        want = jreaders.read_csv(str(tmp_path / "*.csv"), **kw)
        assert got.num_partitions() == want.num_partitions() == 3
        for g, w in zip(got.collect(), want.collect()):
            pd.testing.assert_frame_equal(g, w)
    df.to_json(tmp_path / "d.json", orient="records", lines=True)
    got = readers.read_json(str(tmp_path / "d.json"), lines=True).collect()
    want = jreaders.read_json(str(tmp_path / "d.json"), lines=True).collect()
    pd.testing.assert_frame_equal(got[0], want[0])
    with pytest.raises(FileNotFoundError):
        readers.read_csv(str(tmp_path / "missing*.csv"))


def test_disk_feature_set_matches_jax(tmp_path):
    x, y = _xy(n=23)
    arrays = {"x": x, "y": y}
    got = tfs.FeatureSet(arrays).to_disk(str(tmp_path / "t{host}.zrec"),
                                         block_rows=4)
    want = jfs.FeatureSet(arrays).to_disk(str(tmp_path / "j.zrec"),
                                          block_rows=4)
    assert got.path.endswith("t0.zrec")
    assert len(got) == len(want) == 23 and got.colnames == want.colnames
    assert got.fingerprint() == want.fingerprint()
    for kw in (dict(shuffle=True, seed=5, epoch=2),
               dict(shuffle=False, drop_remainder=False)):
        gb, wb = list(got.batches(6, **kw)), list(want.batches(6, **kw))
        assert len(gb) == len(wb)
        for g, w in zip(gb, wb):
            _same_dicts(g, w)
    it, jit = got.batch_iterator(5, seed=1), want.batch_iterator(5, seed=1)
    for _ in range(2):
        for g, w in zip(it.epoch_batches(), jit.epoch_batches()):
            _same_dicts(g, w)
    _same_dicts(got.to_dram().arrays, arrays)
    _same_dicts(got.sample_block(), want.sample_block())
    got.close()


# ---------------------------------------------------------------------------
# /predict with encoded images
# ---------------------------------------------------------------------------

def _post(port, instances):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=_TIMEOUT)
    try:
        conn.request("POST", "/predict",
                     json.dumps({"instances": instances}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read().decode()
    finally:
        conn.close()


def _encoded(seed, fmt):
    a = np.random.default_rng(seed).integers(0, 256, (11 + seed, 9, 3))
    buf = io.BytesIO()
    Image.fromarray(a.astype(np.uint8)).save(buf, fmt)
    return base64.b64encode(buf.getvalue()).decode()


def test_predict_image_payloads_match_jax():
    """``{"image_b64": ...}`` instances (PNG and JPEG of other sizes,
    resized to ``image_shape``) through the port's stack and the
    reference's on the same SimpleCNN weights: the same logits, equal
    to the model on the decoded, resized images."""
    jm = JaxSimpleCNN(3, dtype=jnp.float32)
    params = jax.device_get(jm.init(jax.random.key(0),
                                    np.zeros((1, 8, 8, 3)))["params"])
    tm = SimpleCNN(3, dtype=torch.float32)
    tm.load_state_dict(params_from_flax(params))
    payloads = [_encoded(i, "PNG" if i % 2 else "JPEG") for i in range(5)]
    instances = [{"image": {"image_b64": p}} for p in payloads]
    cfg = dict(batch_size=4, batch_timeout_ms=20.0, input_cols=["image"],
               image_shape=[8, 8])
    stacks, answers = [], []
    try:
        for im, serving, frontend, config in (
                (InferenceModel().load_torch(tm, device="cpu"),
                 ClusterServing, HttpFrontend, ServingConfig),
                (JaxInferenceModel().load_flax(jm, {"params": params}),
                 JaxServing, JaxFrontend, JaxServingConfig)):
            srv = serving(im, config(**cfg), embedded_broker=True).start()
            stacks.append((srv, frontend(redis_port=srv.port,
                                         timeout=_TIMEOUT,
                                         serving=srv).start()))
        for _, fe in stacks:
            status, text = _post(fe.port, instances)
            assert status == 200, text
            answers.append(np.asarray(json.loads(text)["predictions"]))
    finally:
        for srv, fe in stacks:
            fe.stop()
            srv.stop()
    got, want = answers
    scale = max(1.0, float(np.abs(want).max()))
    assert got.shape == want.shape == (5, 3)
    np.testing.assert_allclose(got, want, atol=_ATOL * scale, rtol=0)
    resize = timage.ImageResize(8, 8)
    imgs = np.stack([resize(timage.decode_image_bytes(base64.b64decode(p)))
                     for p in payloads])
    with torch.no_grad():
        direct = tm(torch.as_tensor(imgs)).numpy()
    np.testing.assert_allclose(got, direct, atol=_ATOL * scale, rtol=0)
