"""The port's disk data pipeline (yolov5m_tpu_torch/data/dataset.py,
loaders.py, native.py) against the JAX package's on the same files.

Batches must be EXACTLY equal: images, labels, masks, image_valid and
orig_hw, over coco and yolo labels, rect on and off, multi-scale buckets,
host mosaic and HSV (cv2 is installed here), TrainAugment with the same
per-item generators, the device-augment split of get_loaders, prefetch
threads and a padded short val batch. The JAX side reads PNG through PIL
and JPEG through its libjpeg library; the port reads the same PNG and
JPEG files (JPEG through its own decoder, bitwise libjpeg's), and a PPM twin of
the dataset (same pixels as the PNG) through its numpy decoder, which the
JAX listing does not accept. Both loaders resize in C libraries built the
same way from the same code, so no resize is patched. Also: the box
remainder of ops/boxes.py and decode_grid_targets against JAX."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_datasets import write_dataset, write_image
from yolov5m_tpu.data import dataset as jdataset
from yolov5m_tpu.data import loaders as jloaders
from yolov5m_tpu.data import native as jnative
from yolov5m_tpu.ops import boxes as jboxes
from yolov5m_tpu.ops import decode as jdecode
from yolov5m_tpu_torch.data import dataset, loaders, native
from yolov5m_tpu_torch.ops import boxes, decode

torch.set_num_threads(1)


def _batches(loader, epochs=(1, 2)):
    out = []
    for e in epochs:
        loader.set_epoch(e)
        out += list(loader)
    return out


def _assert_equal(got, want):
    assert len(got) == len(want) and len(got) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


# (box format, get_loaders kwargs, which loader, default size)
CASES = {
    "coco_plain": ("coco", {"augment": False}, "train", 64),
    "yolo_plain": ("yolo", {"augment": False}, "train", 64),
    "rect_train": ("coco", {"rect_training": True}, "train", 96),
    "rect_val": ("coco", {"rect_training": True}, "val", 96),
    "multi_scale": ("coco", {"multi_scale_sizes": [64, 96]}, "train", 96),
    "mosaic_hsv_augment": ("coco", {"mosaic_p": 0.5, "hsv": True,
                                    "multi_scale_sizes": [64, 96]},
                           "train", 96),
    "device_augment_split": ("yolo", {"device_augment": True,
                                      "mosaic_p": 0.3}, "train", 64),
    "val_short_batch": ("coco", {}, "val", 64),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_batches_equal_jax(case, tmp_path):
    box_format, kw, which, size = CASES[case]
    png = write_dataset(str(tmp_path / "png"), "png", box_format)
    ppm = write_dataset(str(tmp_path / "ppm"), "ppm", box_format)
    jpg = write_dataset(str(tmp_path / "jpg"), "jpg", box_format)
    common = dict(box_format=box_format, max_boxes=6, default_size=size, **kw)
    pick = 0 if which == "train" else 1
    # the port first, so it builds the annotation caches the JAX side reads
    port = loaders.get_loaders(png, 4, num_workers=2, **common)[pick]
    port_ppm = loaders.get_loaders(ppm, 4, **common)[pick]
    port_jpg = loaders.get_loaders(jpg, 4, num_workers=2, **common)[pick]
    want = _batches(jloaders.get_loaders(png, 4, **common)[pick])
    got = _batches(port)
    port.close()
    _assert_equal(got, want)
    _assert_equal(_batches(port_ppm), want)
    want_jpg = _batches(jloaders.get_loaders(jpg, 4, **common)[pick])
    got_jpg = _batches(port_jpg)
    port_jpg.close()
    _assert_equal(got_jpg, want_jpg)
    if case == "val_short_batch":
        assert not want[-1]["image_valid"].all()
        assert (want[-1]["image"][~want[-1]["image_valid"]] == 0).all()


@pytest.mark.parametrize("case", ["mosaic_hsv_augment", "rect_train",
                                  "val_short_batch"])
def test_rank_rows_equal_single_process_rows(case, tmp_path):
    """BatchLoader(rank=r, world_size=2) yields exactly rows [2r, 2r + 2)
    of each single-process batch of 4: per-item generators keyed by the
    global row, the size drawn per global batch, padding where the global
    batch is short."""
    box_format, kw, which, size = CASES[case]
    root = write_dataset(str(tmp_path / "ppm"), "ppm", box_format)
    common = dict(box_format=box_format, max_boxes=6, default_size=size, **kw)
    pick = 0 if which == "train" else 1
    whole = loaders.get_loaders(root, 4, **common)[pick]
    want = _batches(whole)
    for r in range(2):
        part = dataset.BatchLoader(
            whole.ds, 4, shuffle=whole.shuffle, augment=whole.augment,
            seed=whole.seed, drop_last=whole.drop_last,
            size_buckets=whole.size_buckets, mosaic_p=whole.mosaic_p,
            hsv=whole.hsv, rank=r, world_size=2)
        got = _batches(part)
        _assert_equal(got, [{k: v[2 * r:2 * r + 2] for k, v in w.items()}
                            for w in want])
    if case == "val_short_batch":
        assert not got[-1]["image_valid"].all()
    with pytest.raises(ValueError, match="not divisible"):
        dataset.BatchLoader(whole.ds, 4, rank=0, world_size=3)


def test_unresized_batches_equal_unpatched_jax(tmp_path):
    """64x64 sources at size 64: the JAX loader with its own C resize (no
    resize happens) gives the same batches."""
    root = str(tmp_path / "d")
    write_dataset(root, "png", n_train=6, n_val=2)
    rng = np.random.default_rng(5)
    for split in ("train", "val"):
        folder = os.path.join(root, "images", split)
        for name in os.listdir(folder):
            write_image(os.path.join(folder, name),
                        rng.integers(0, 256, (64, 64, 3), np.uint8), "png")
    kw = dict(max_boxes=6, default_size=64, mosaic_p=0.5)
    got = _batches(loaders.get_loaders(root, 2, **kw)[0])
    _assert_equal(got, _batches(jloaders.get_loaders(root, 2, **kw)[0]))


@pytest.mark.parametrize("box_format", ["coco", "yolo"])
def test_label_file_equals_jax(box_format, tmp_path):
    p = tmp_path / "l.txt"
    if box_format == "coco":
        p.write_text("10 20 100 50.1237 3\n-1 5 10 10 2\n0.5 7.25 3 4 80\n")
    else:
        p.write_text("2 0.5 0.25 0.1234567 0.9876543\n1 -0.1 0.2 0.3 0.4\n")
    got = dataset.load_label_file(str(p), box_format, 640.0, 480.0)
    want = jdataset.load_label_file(str(p), box_format, 640.0, 480.0)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32 and len(got) == (2 if box_format == "coco"
                                                    else 1)
    p.write_text("")
    assert dataset.load_label_file(str(p), box_format, 1, 1).shape == (0, 5)


def test_sizes_labels_and_caches_equal_jax(tmp_path):
    png = write_dataset(str(tmp_path / "png"), "png")
    ppm = write_dataset(str(tmp_path / "ppm"), "ppm")
    for rect in (False, True):
        ds = dataset.DetectionDataset(png, rect_training=rect, bs=4,
                                      default_size=96)
        ds_ppm = dataset.DetectionDataset(ppm, rect_training=rect, bs=4,
                                          default_size=96)
        jds = jdataset.DetectionDataset(png, rect_training=rect, bs=4,
                                        default_size=96)
        assert ds.annotations == jds.annotations
        assert ds.orig_sizes == jds.orig_sizes
        assert ds.batch_range == jds.batch_range == 64
        assert [(h, w) for _, h, w in ds_ppm.annotations] == \
            [(h, w) for _, h, w in ds.annotations]
        for i in range(len(ds)):
            np.testing.assert_array_equal(ds.load_labels(i), jds.load_labels(i))
            np.testing.assert_array_equal(ds_ppm.load_labels(i),
                                          jds.load_labels(i))
    # the rect plan is cached per default size
    names = sorted(os.listdir(os.path.join(png, "labels")))
    assert "adaptive_ann_train_10_br_64_sz_96.csv" in names
    assert "annot_train.csv" in names
    other = dataset.DetectionDataset(png, rect_training=True, bs=4,
                                     default_size=64)
    assert {h for _, h, _ in other.annotations} != \
        {h for _, h, _ in dataset.DetectionDataset(
            png, rect_training=True, bs=4, default_size=96).annotations}
    # the JAX listing does not take PPM; the port's does
    assert len(jdataset.DetectionDataset(ppm, train=False)) == 0
    assert len(dataset.DetectionDataset(ppm, train=False)) == 5
    # bs 24 rounds the reference's 64 down to a multiple of bs
    assert dataset.DetectionDataset(png, bs=24).batch_range == \
        jdataset.DetectionDataset(png, bs=24).batch_range == 48


def test_image_io(tmp_path):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (37, 53, 3), np.uint8)
    for fmt in ("png", "ppm"):
        path = str(tmp_path / f"a.{fmt}")
        write_image(path, img, fmt)
        np.testing.assert_array_equal(native.load_image_rgb(path), img)
        assert native.read_image_size(path) == (37, 53)
    path = str(tmp_path / "a.jpg")
    write_image(path, img, "jpg")
    np.testing.assert_array_equal(native.load_image_rgb(path),
                                  jnative.load_image_rgb(path))
    assert native.read_image_size(path) == (37, 53)
    # a header with a comment
    path = tmp_path / "c.ppm"
    path.write_bytes(b"P6\n# made by a test\n53 37\n255\n" + img.tobytes())
    assert native.read_image_size(str(path)) == (37, 53)
    np.testing.assert_array_equal(native.load_image_rgb(str(path)), img)
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not an image")
    with pytest.raises(ValueError, match="bad.png"):
        native.load_image_rgb(str(bad))
    with pytest.raises(ValueError, match="bad.png"):
        native.read_image_size(str(bad))


def test_jpeg_dataset_is_listed_sized_and_read_without_pil(tmp_path,
                                                          monkeypatch):
    """The card's machine has no PIL: JPEG files are listed, sized from
    their headers and decoded by the port's own JPEG decoder, to
    JAX's batches."""
    root = write_dataset(str(tmp_path / "jpg"), "jpg")
    kw = dict(max_boxes=6, default_size=96, rect_training=True)
    want = _batches(jloaders.get_loaders(root, 4, **kw)[0])
    want_sizes = jdataset.DetectionDataset(root, rect_training=True, bs=4,
                                           default_size=96).orig_sizes
    for name in os.listdir(os.path.join(root, "labels")):
        if name.endswith(".csv"):           # the caches the JAX side wrote
            os.remove(os.path.join(root, "labels", name))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError):
        from PIL import Image  # noqa: F401
    ds = dataset.DetectionDataset(root, rect_training=True, bs=4,
                                  default_size=96)
    assert len(ds) == 10 and ds.orig_sizes == want_sizes
    _assert_equal(_batches(loaders.get_loaders(root, 4, **kw)[0]), want)


def test_pillow_route_files_named_jpg_load_as_jax(tmp_path, monkeypatch):
    """Files named .jpg that the JAX loader's libjpeg refuses and hands to
    Pillow (a CMYK JPEG, a YCCK one, a lossless one, a BMP and a GIF): the
    port, without PIL, sizes them as Pillow does and yields JAX's batches."""
    from PIL import Image

    from tests import torch_pillow_corpus as pcorpus

    root = write_dataset(str(tmp_path / "jpg"), "jpg", n_train=6, n_val=2)
    folder = os.path.join(root, "images", "train")
    for i, make in enumerate((
            lambda a: pcorpus.encode(pcorpus.cmyk_samples(a), pcorpus.CMYK,
                                     [2, 2, 1, 1, 1, 1, 2, 2]),
            lambda a: pcorpus.encode(pcorpus.cmyk_samples(a), pcorpus.YCCK,
                                     [1] * 8, progressive=True),
            lambda a: pcorpus.encode(a, pcorpus.RGB, [1] * 6, psv=4),
            lambda a: pcorpus.bmp(pcorpus.bmp_rows(a, 24), a.shape[1],
                                  a.shape[0], 24),
            lambda a: pcorpus.gif(pcorpus.quantized(a, 256)[0],
                                  table=pcorpus.quantized(a, 256)[1]))):
        path = os.path.join(folder, f"img{i:02d}.jpg")
        with Image.open(path) as im:
            arr = np.asarray(im.convert("RGB"))
        with open(path, "wb") as f:
            f.write(make(arr))
        assert jnative.decode_jpeg(path) is None
    kw = dict(max_boxes=6, default_size=96, rect_training=True)
    want = _batches(jloaders.get_loaders(root, 4, **kw)[0])
    want_sizes = jdataset.DetectionDataset(root, rect_training=True, bs=4,
                                           default_size=96).orig_sizes
    for name in os.listdir(os.path.join(root, "labels")):
        if name.endswith(".csv"):           # the caches the JAX side wrote
            os.remove(os.path.join(root, "labels", name))
    monkeypatch.setitem(sys.modules, "PIL", None)
    ds = dataset.DetectionDataset(root, rect_training=True, bs=4,
                                  default_size=96)
    assert ds.orig_sizes == want_sizes
    _assert_equal(_batches(loaders.get_loaders(root, 4, **kw)[0]), want)


@pytest.mark.parametrize("fmt", ["jpg", "png"])
def test_webp_files_named_jpg_png_load_as_jax(fmt, tmp_path, monkeypatch):
    """WebP files (lossy, lossless, with alpha, animated) named .jpg or .png,
    as scraped datasets hold them, which the JAX loader hands to Pillow:
    the port, without PIL, sizes them as Pillow does (read_image_size
    demuxes the whole file) and yields JAX's batches, and the batches of a
    twin dataset of PPM files holding Pillow's pixels."""
    import shutil

    from PIL import Image

    from tests import torch_webp_corpus as wcorpus

    root = write_dataset(str(tmp_path / fmt), fmt, n_train=6, n_val=2)
    folder = os.path.join(root, "images", "train")
    for i, make in enumerate((
            lambda a: wcorpus.pil(a, quality=80),
            lambda a: wcorpus.pil(a, lossless=True),
            lambda a: wcorpus.encode(wcorpus.with_alpha(a, i), quality=85,
                                     filter_type=0, partitions=2, method=0),
            lambda a: wcorpus.animation(
                a.shape[1::-1], [(0, 0, a.shape[1], a.shape[0],
                                  wcorpus.image_chunks(wcorpus.pil(a)))]))):
        path = os.path.join(folder, f"img{i:02d}.{fmt}")
        with Image.open(path) as im:
            arr = np.asarray(im.convert("RGB"))
        with open(path, "wb") as f:
            f.write(make(arr))
    twin = shutil.copytree(root, str(tmp_path / "twin"))
    for split in ("train", "val"):
        d = os.path.join(twin, "images", split)
        for name in os.listdir(d):
            with Image.open(os.path.join(d, name)) as im:
                arr = np.asarray(im.convert("RGB"))
            os.remove(os.path.join(d, name))
            write_image(os.path.join(d, name[:-len(fmt)] + "ppm"), arr,
                        "ppm")
    kw = dict(max_boxes=6, default_size=96, rect_training=True)
    want = _batches(jloaders.get_loaders(root, 4, **kw)[0])
    want_sizes = jdataset.DetectionDataset(root, rect_training=True, bs=4,
                                           default_size=96).orig_sizes
    for name in os.listdir(os.path.join(root, "labels")):
        if name.endswith(".csv"):           # the caches the JAX side wrote
            os.remove(os.path.join(root, "labels", name))
    monkeypatch.setitem(sys.modules, "PIL", None)
    for i in range(4):
        path = os.path.join(folder, f"img{i:02d}.{fmt}")
        assert native.read_image_size(path) == \
            native.load_image_rgb(path).shape[:2]
    ds = dataset.DetectionDataset(root, rect_training=True, bs=4,
                                  default_size=96)
    assert ds.orig_sizes == want_sizes
    got = _batches(loaders.get_loaders(root, 4, **kw)[0])
    _assert_equal(got, want)
    _assert_equal(got, _batches(loaders.get_loaders(twin, 4, **kw)[0]))


def _pnm_makers():
    """PNM writers of an (h, w, 3) image: plain P3, a 16-bit P5 of its
    grey, a P6 at maxval 1000, a plain P2 at maxval 300 and a Pf."""
    from tests import torch_pnm_corpus as corpus

    def grey(a):
        return a.astype(np.int64).sum(-1) // 3

    def scaled(a, m):
        return np.round(a.astype(np.int64) * (m / 255)).astype(np.int64)

    return (
        lambda a: corpus.header(b"P3", a.shape[1], a.shape[0], 255) +
        corpus.plain(a),
        lambda a: corpus.header(b"P5", a.shape[1], a.shape[0], 65535) +
        corpus.binary(grey(a), 65535),
        lambda a: corpus.header(b"P6", a.shape[1], a.shape[0], 1000) +
        corpus.binary(scaled(a, 1000), 1000),
        lambda a: corpus.header(b"P2", a.shape[1], a.shape[0], 300) +
        corpus.plain(scaled(grey(a), 300)),
        lambda a: corpus.pfm(grey(a).astype(np.float32) + 0.5, b"-1.0"))


@pytest.mark.parametrize("ext", ["ppm", "jpg"])
def test_pnm_files_load_as_jax(ext, tmp_path, monkeypatch):
    """PNM files Pillow's PPM plugin reads (plain P3 and P2, a 16-bit P5,
    a P6 at maxval 1000, a Pf), named .jpg for the JAX loader, whose
    listing takes no .ppm, and .ppm or .jpg for the port's: the port,
    without PIL, sizes them as Pillow's open does and yields JAX's
    batches."""
    import shutil

    from PIL import Image

    root = write_dataset(str(tmp_path / "jax"), "jpg", n_train=6, n_val=2)
    folder = os.path.join(root, "images", "train")
    for i, make in enumerate(_pnm_makers()):
        path = os.path.join(folder, f"img{i:02d}.jpg")
        with Image.open(path) as im:
            arr = np.asarray(im.convert("RGB"))
        with open(path, "wb") as f:
            f.write(make(arr))
    kw = dict(max_boxes=6, default_size=96, rect_training=True)
    want = _batches(jloaders.get_loaders(root, 4, **kw)[0])
    want_sizes = jdataset.DetectionDataset(root, rect_training=True, bs=4,
                                           default_size=96).orig_sizes
    for name in os.listdir(os.path.join(root, "labels")):
        if name.endswith(".csv"):           # the caches the JAX side wrote
            os.remove(os.path.join(root, "labels", name))
    port = shutil.copytree(root, str(tmp_path / "port"))
    for split in ("train", "val"):
        d = os.path.join(port, "images", split)
        for name in os.listdir(d):
            os.rename(os.path.join(d, name),
                      os.path.join(d, name[:-3] + ext))
    monkeypatch.setitem(sys.modules, "PIL", None)
    for i in range(len(_pnm_makers())):
        path = os.path.join(port, "images", "train", f"img{i:02d}.{ext}")
        assert native.read_image_size(path) == \
            native.load_image_rgb(path).shape[:2]
    ds = dataset.DetectionDataset(port, rect_training=True, bs=4,
                                  default_size=96)
    assert ds.orig_sizes == {k[:-3] + ext: v for k, v in want_sizes.items()}
    _assert_equal(_batches(loaders.get_loaders(port, 4, **kw)[0]), want)


def test_tiff_files_load_as_jax(tmp_path, monkeypatch):
    """TIFF files named .jpg, which the JAX loader hands to Pillow: LZW
    with predictor 2, deflate tiles, PackBits and uncompressed planes
    under Orientation 6 and 8, 16-bit grey. The port, without PIL, sizes
    them as Pillow's open does (sides swapped under Orientation 6 and 8),
    so the labels scale as JAX scales them, and yields JAX's batches."""
    from PIL import Image

    from tests import torch_tiff_corpus as corpus

    def grey(a):
        return (a.astype(np.int64).sum(-1) // 3).astype(np.uint16)

    makers = (lambda a: corpus.encode(a, "lzw", predictor=2),
              lambda a: corpus.encode(a, "deflate", tile=32),
              lambda a: corpus.encode(a, "packbits", orientation=6),
              lambda a: corpus.encode(a, "raw", planar=True, orientation=8),
              lambda a: corpus.encode(grey(a), "raw", rows_per_strip=7))
    root = write_dataset(str(tmp_path / "jax"), "jpg", n_train=6, n_val=2)
    folder = os.path.join(root, "images", "train")
    shapes = []
    for i, make in enumerate(makers):
        path = os.path.join(folder, f"img{i:02d}.jpg")
        with Image.open(path) as im:
            arr = np.asarray(im.convert("RGB"))
        shapes.append(arr.shape[:2])
        with open(path, "wb") as f:
            f.write(make(arr))
    kw = dict(max_boxes=6, default_size=96, rect_training=True)
    want = _batches(jloaders.get_loaders(root, 4, **kw)[0])
    want_sizes = jdataset.DetectionDataset(root, rect_training=True, bs=4,
                                           default_size=96).orig_sizes
    for name in os.listdir(os.path.join(root, "labels")):
        if name.endswith(".csv"):           # the caches the JAX side wrote
            os.remove(os.path.join(root, "labels", name))
    monkeypatch.setitem(sys.modules, "PIL", None)
    assert any(h != w for h, w in shapes)
    for i in range(len(makers)):
        path = os.path.join(folder, f"img{i:02d}.jpg")
        hw = native.read_image_size(path)
        assert hw == native.load_image_rgb(path).shape[:2]
        assert hw == (shapes[i][::-1] if i in (2, 3) else shapes[i])
    ds = dataset.DetectionDataset(root, rect_training=True, bs=4,
                                  default_size=96)
    assert ds.orig_sizes == want_sizes
    _assert_equal(_batches(loaders.get_loaders(root, 4, **kw)[0]), want)


def test_undecodable_dataset_image_raises_naming_it(tmp_path):
    root = write_dataset(str(tmp_path / "d"), "ppm")
    path = os.path.join(root, "images", "train", "img03.ppm")
    with open(path, "r+b") as f:
        f.truncate(20)                 # header intact, pixels cut off
    loader = loaders.get_loaders(root, 2, augment=False, default_size=64)[0]
    with pytest.raises(ValueError, match="img03.ppm"):
        list(loader)


def test_to_device_keeps_values():
    a = np.random.default_rng(0).uniform(0, 1, (2, 8, 8, 3)).astype(np.float32)
    t = loaders.to_device(a, torch.device("cpu"))
    assert isinstance(t, torch.Tensor) and np.array_equal(t.numpy(), a)
    assert loaders.to_device(t, torch.device("cpu")) is t


def test_box_remainder_equals_jax():
    rng = np.random.default_rng(2)
    b = rng.uniform(1, 300, (5, 7, 4)).astype(np.float32)
    pairs = [
        (boxes.coco_to_yolo(torch.from_numpy(b), 640.0, 480.0),
         jboxes.coco_to_yolo(jnp.asarray(b), 640.0, 480.0)),
        (boxes.xyxy_to_xywhn(torch.from_numpy(b), 640, 480),
         jboxes.xyxy_to_xywhn(jnp.asarray(b), 640, 480)),
        (boxes.rescale_boxes(torch.from_numpy(b), (640, 480), (1280, 720)),
         jboxes.rescale_boxes(jnp.asarray(b), (640, 480), (1280, 720))),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-5)


def test_decode_grid_targets_equals_jax():
    rng = np.random.default_rng(3)
    targets = [rng.uniform(0, 4, (2, 3, n, n + 1, 6)).astype(np.float32)
               for n in (8, 4, 2)]
    got = decode.decode_grid_targets([torch.from_numpy(t) for t in targets])
    want = jdecode.decode_grid_targets([jnp.asarray(t) for t in targets])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
