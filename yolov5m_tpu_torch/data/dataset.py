"""COCO/FLIR txt-label datasets on disk, as fixed-shape padded numpy batches.

Port of ``yolov5m_tpu/data/dataset.py``:
  * layout {root}/images/{train,val} and {root}/labels/{split}/*.txt;
  * the image-size annotation CSV, built once and cached;
  * coco -> yolo conversion with 0-indexed classes, negative rows dropped,
    and the reference's truncation of columns 3:5 (see load_label_file);
  * rectangular training: ratio-sorted buckets of ``batch_range`` images,
    one stride-32 shape each, cached to a CSV keyed by split, count,
    batch range and default size;
  * BatchLoader: batches of one (H, W), multi-scale buckets, host mosaic,
    HSV and TrainAugment, each item with its own generator seeded from
    hash((seed, epoch, batch_idx, k)), thread prefetch.

Batches are numpy: {"image": (bs, H, W, 3) float32 / 255, "labels": (bs,
nb, 5), "mask": (bs, nb), "image_valid": (bs,), "orig_hw": (bs, 2)}. The
trainer and the evaluator move them to the card. Images are listed as
.jpg, .png, .jpeg or .ppm, and decoded by content: JPEG, PNG, BMP, GIF,
WebP, PNM (P1-P6 at every maxval, Pf) and TIFF (uncompressed, LZW,
deflate, PackBits, JPEG at 8 and 12 bits, old-style JPEG, ZSTD, LZMA,
CCITT fax, ThunderScan; YCbCr and CIELab among them) with the port's
decoders, as the JAX loader's libjpeg and Pillow decode them, and every
size is read as
Pillow's open reads it (a TIFF's from IFD0, Orientation 5-8 swapping it). The resize is the
C library's (``data/native.py``). A file that cannot be decoded raises,
naming it.
"""

from __future__ import annotations

import os
import warnings
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from yolov5m_tpu_torch.data.native import (load_image_rgb, read_image_size,
                                           resize_bilinear)

# image extensions tried, in order, for a label file's stem
IMAGE_EXTS = (".jpg", ".png", ".jpeg", ".ppm")


def _coco_to_yolo_np(b: np.ndarray, w0: float, h0: float) -> np.ndarray:
    """(x1, y1, w, h) absolute -> (cx, cy, w, h) normalized."""
    x1, y1, w, h = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
    return np.stack([(2 * x1 + w) / (2 * w0), (2 * y1 + h) / (2 * h0),
                     w / w0, h / h0], axis=1)


def load_label_file(path: str, box_format: str, w0: float, h0: float) -> np.ndarray:
    """One txt label file -> (n, 5) float32 rows (class, x, y, w, h)
    normalized. Rows with a negative value are dropped; columns 3:5 are
    truncated to 3 decimals BEFORE the coco roll, as the reference does: on
    coco rows (x1, y1, w, h, cls) those columns are (h in pixels, class),
    so only yolo-format labels really lose digits. Coco classes count from
    1 and become 0-indexed."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        labels = np.loadtxt(path, delimiter=" ", ndmin=2, dtype=np.float64)
    if labels.size == 0:
        return np.zeros((0, 5), np.float32)
    labels = labels[np.all(labels >= 0, axis=1)]
    if labels.shape[0] == 0:
        return np.zeros((0, 5), np.float32)
    labels[:, 3:5] = np.floor(labels[:, 3:5] * 1000) / 1000
    if box_format == "coco":
        labels[:, -1] -= 1                         # classes 1..80 -> 0..79
        labels = np.roll(labels, axis=1, shift=1)  # (cls, x1, y1, w, h)
        labels[:, 1:] = _coco_to_yolo_np(labels[:, 1:], w0, h0)
    return labels.astype(np.float32)


def _read_rows(csv_path: str) -> List[Tuple[str, int, int]]:
    """(name, h, w) rows of an index,name,h,w CSV; a header line is
    skipped."""
    rows = []
    with open(csv_path) as f:
        for line in f.read().strip().splitlines():
            parts = line.split(",")
            if len(parts) >= 4 and parts[1].strip():
                try:
                    rows.append((parts[1], int(float(parts[2])),
                                 int(float(parts[3]))))
                except ValueError:
                    continue
    return rows


def _write_rows(csv_path: str, rows) -> None:
    with open(csv_path, "w") as f:
        for i, (n, h, w) in enumerate(rows):
            f.write(f"{i},{n},{h},{w}\n")


class DetectionDataset:
    """Index of images and labels with cached sizes and rect buckets."""

    def __init__(self, root_directory: str, train: bool = True,
                 rect_training: bool = False, default_size: int = 640,
                 bs: int = 64, bboxes_format: str = "coco",
                 max_boxes: int = 120):
        if bboxes_format not in ("coco", "yolo"):
            raise ValueError(f"bboxes_format {bboxes_format!r}: coco or yolo")
        self.root = root_directory
        self.train = train
        self.split = "train" if train else "val"
        self.rect = rect_training
        self.default_size = default_size
        self.bs = bs
        # the reference's 64/128, rounded down to a multiple of bs so that
        # no batch straddles two shape buckets (a batch takes the shape of
        # its first item)
        ref_range = 64 if bs < 64 else 128
        self.batch_range = max((ref_range // bs) * bs, bs)
        self.box_format = bboxes_format
        self.max_boxes = max_boxes

        self.images_dir = os.path.join(self.root, "images", self.split)
        self.labels_dir = os.path.join(self.root, "labels", self.split)
        annot_csv = os.path.join(self.root, "labels", f"annot_{self.split}.csv")

        self.annotations = self._load_or_build_annotations(annot_csv)
        # source sizes by name: the rect planner rewrites the annotation
        # rows, and eval rescales boxes and areas to source pixels
        self.orig_sizes = {name: (h, w) for name, h, w in self.annotations}
        if rect_training:
            self.annotations = self._adaptive_shape(self.annotations)

    def _load_or_build_annotations(self, csv_path: str) -> List[Tuple[str, int, int]]:
        """[(name, h, w)], sorted; cached as index,name,h,w."""
        if os.path.isfile(csv_path):
            rows = _read_rows(csv_path)
            if rows:
                return sorted(rows)
        rows = []
        for label_file in sorted(os.listdir(self.labels_dir)):
            if not label_file.endswith(".txt"):
                continue
            stem = label_file[:-4]
            for ext in IMAGE_EXTS:
                img_path = os.path.join(self.images_dir, stem + ext)
                if os.path.isfile(img_path):
                    break
            else:
                continue                  # a label without an image
            h, w = read_image_size(img_path)
            rows.append((stem + ext, h, w))
        os.makedirs(os.path.dirname(csv_path), exist_ok=True)
        _write_rows(csv_path, rows)
        return sorted(rows)

    def _adaptive_shape(self, annotations, seed: int = 0):
        """Rect shape planner: sort by w/h, bucket by batch_range, give each
        bucket one stride-32 shape (+-10% jitter for train), shuffle within
        the bucket. Cached to a CSV whose name holds the default size, so a
        run at another --image_size plans anew."""
        cache = os.path.join(
            self.root, "labels",
            f"adaptive_ann_{self.split}_{len(annotations)}_br_"
            f"{self.batch_range}_sz_{self.default_size}.csv")
        if os.path.isfile(cache):
            rows = _read_rows(cache)
            if rows:
                return rows

        rng = np.random.default_rng(seed)
        ann = sorted(annotations, key=lambda r: r[2] / r[1])  # w/h ratio
        out = []
        for i in range(0, len(ann), self.batch_range):
            bucket = ann[i:i + self.batch_range]
            name0, h0, w0 = bucket[0]
            size = [float(w0), float(h0)]
            max_idx = 0 if size[0] >= size[1] else 1
            min_idx = 1 - max_idx
            size[min_idx] += 32
            if self.train:
                sz = int(rng.integers(int(self.default_size * 0.9),
                                      int(self.default_size * 1.1))) // 32 * 32
            else:
                sz = self.default_size
            size[min_idx] = (sz / size[max_idx] * size[min_idx]) // 32 * 32
            size[max_idx] = sz
            w_t, h_t = int(size[0]), int(size[1])
            shaped = [(n, max(h_t, 32), max(w_t, 32)) for n, _, _ in bucket]
            rng.shuffle(shaped)
            out.extend(shaped)
        _write_rows(cache, out)
        return out

    def __len__(self) -> int:
        return len(self.annotations)

    def load_item(self, idx: int, target_hw: Optional[Tuple[int, int]] = None):
        """(image float32 HWC in [0, 255], labels (n, 5))."""
        name, h_t, w_t = self.annotations[idx]
        if target_hw is not None:
            h_t, w_t = target_hw
        elif not self.rect:
            h_t = w_t = self.default_size
        img = load_image_rgb(os.path.join(self.images_dir, name))
        label_path = os.path.join(self.labels_dir, os.path.splitext(name)[0] + ".txt")
        labels = load_label_file(label_path, self.box_format,
                                 w0=img.shape[1], h0=img.shape[0])
        img = resize_bilinear(img, (int(w_t), int(h_t)))
        return img.astype(np.float32), labels

    def load_labels(self, idx: int) -> np.ndarray:
        """Labels only, normalized with the cached source size, without
        decoding the image (autoanchor scans every item)."""
        name, _, _ = self.annotations[idx]
        h0, w0 = self.orig_sizes[name]
        label_path = os.path.join(self.labels_dir,
                                  os.path.splitext(name)[0] + ".txt")
        return load_label_file(label_path, self.box_format, w0=w0, h0=h0)

    def item_shape(self, idx: int) -> Tuple[int, int]:
        name, h, w = self.annotations[idx]
        if not self.rect:
            return (self.default_size, self.default_size)
        return (h, w)


class BatchLoader:
    """Fixed-shape batch iterator over a DetectionDataset.

    size_buckets: multi-scale sizes (multiples of 32), one drawn per batch;
    ignored under rect training. drop_last: training loaders set it; a
    short final batch is otherwise padded with zero images and empty
    labels, marked by ``image_valid``, which only the evaluator reads.
    num_workers > 0 builds up to ``prefetch_depth`` batches ahead on a
    thread pool (the C decode and resize release the GIL).

    rank, world_size: data parallelism. ``batch_size`` stays the global
    batch, and the loader builds only rows [rank*per, (rank+1)*per) of it
    (per = batch_size / world_size). Each item keeps its global row k in
    its generator's seed and the size is drawn per global batch, so rank
    r's rows are exactly those rows of the single-process batch."""

    def __init__(self, dataset: DetectionDataset, batch_size: int,
                 shuffle: bool = False, augment=None, seed: int = 0,
                 drop_last: bool = False,
                 size_buckets: Optional[Sequence[int]] = None,
                 num_workers: int = 0, prefetch_depth: int = 2,
                 mosaic_p: float = 0.0, hsv: bool = False,
                 rank: int = 0, world_size: int = 1):
        if batch_size % world_size:
            raise ValueError(f"batch size {batch_size} is not divisible by "
                             f"{world_size} ranks")
        self.ds = dataset
        self.bs = batch_size
        self.per = batch_size // world_size
        self.row0 = rank * self.per
        self.shuffle = shuffle and not dataset.rect
        self.augment = augment
        self.seed = seed
        self.epoch = 0
        self._epoch_explicit = False  # auto-advance per pass until set_epoch
        self._auto_epoch = 0
        self.drop_last = drop_last
        self.size_buckets = None
        if size_buckets and not dataset.rect:
            if any(s % 32 for s in size_buckets):
                raise ValueError(f"multi-scale sizes must be multiples of 32: "
                                 f"{list(size_buckets)}")
            self.size_buckets = tuple(size_buckets)
        self.num_workers = num_workers
        self.prefetch_depth = prefetch_depth if num_workers > 0 else 0
        self._pool = None
        self._warned_padding = False
        self.mosaic_p = mosaic_p
        self.hsv = hsv

    def __len__(self) -> int:
        n = len(self.ds)
        return n // self.bs if self.drop_last else (n + self.bs - 1) // self.bs

    def set_epoch(self, epoch: int) -> None:
        """Fold the epoch into every random stream (order, size, per-item
        augmentation). Without it, each pass advances an internal count."""
        self.epoch = int(epoch)
        self._epoch_explicit = True

    def close(self) -> None:
        """Stop the prefetch threads (the pool is made again on the next
        pass)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None

    def __iter__(self) -> Iterator[dict]:
        if self._epoch_explicit:
            epoch = self.epoch
        else:
            epoch = self._auto_epoch
            self._auto_epoch += 1
        return self._iter_epoch(epoch)

    def _iter_epoch(self, epoch: int) -> Iterator[dict]:
        order = np.arange(len(self.ds))
        if self.shuffle:
            # a tuple of ints hashes the same in every process
            np.random.default_rng(
                hash((self.seed, epoch)) & 0x7FFFFFFF).shuffle(order)
        batches = []
        for start in range(0, len(order), self.bs):
            idxs = order[start:start + self.bs]
            if len(idxs) < self.bs and self.drop_last:
                break
            batches.append((idxs, start // self.bs, epoch))

        if self.prefetch_depth <= 0:
            for args in batches:
                yield self._make_batch(*args)
            return

        import concurrent.futures as cf
        if self._pool is None:
            self._pool = cf.ThreadPoolExecutor(max_workers=max(self.num_workers, 1))
        pending = []
        it = iter(batches)
        try:
            for _ in range(self.prefetch_depth):
                nxt = next(it, None)
                if nxt is None:
                    break
                pending.append(self._pool.submit(self._make_batch, *nxt))
            while pending:
                fut = pending.pop(0)
                nxt = next(it, None)
                if nxt is not None:
                    pending.append(self._pool.submit(self._make_batch, *nxt))
                yield fut.result()
        finally:
            for fut in pending:
                fut.cancel()

    def _make_batch(self, idxs: np.ndarray, batch_idx: int,
                    epoch: int = 0) -> dict:
        hw = self.ds.item_shape(int(idxs[0]))
        if self.size_buckets is not None:
            s = int(np.random.default_rng(
                hash((self.seed, epoch, batch_idx, -1)) & 0x7FFFFFFF)
                .choice(self.size_buckets))
            hw = (s, s)
        nb, per = self.ds.max_boxes, self.per
        # this rank's rows of the global batch: (row j, global row k, idx)
        rows = [(k - self.row0, k, idxs[k])
                for k in range(self.row0, min(self.row0 + per, len(idxs)))]
        imgs = np.zeros((per, hw[0], hw[1], 3), np.float32)
        labels = np.zeros((per, nb, 5), np.float32)
        mask = np.zeros((per, nb), bool)
        image_valid = np.zeros(per, bool)
        image_valid[:len(rows)] = True
        # padded rows keep the network size (an identity rescale)
        orig_hw = np.tile(np.asarray(hw, np.int32), (per, 1))
        for j, _, idx in rows:
            name = self.ds.annotations[int(idx)][0]
            o = self.ds.orig_sizes.get(name)
            if o is not None:
                orig_hw[j] = o
        if len(idxs) < self.bs and self.augment is not None \
                and not self._warned_padding:
            self._warned_padding = True
            warnings.warn(
                "BatchLoader with augmentation yielded a zero-padded short "
                "batch (drop_last=False): a train step has no image_valid "
                "input, so the blank padding enters the loss and BN stats — "
                "use drop_last=True for training loaders", stacklevel=2)
        for j, k, idx in rows:
            item_rng = np.random.default_rng(
                hash((self.seed, epoch, batch_idx, k)) & 0x7FFFFFFF)
            if self.mosaic_p > 0 and item_rng.random() < self.mosaic_p \
                    and hw[0] == hw[1]:
                from yolov5m_tpu_torch.data.augment import mosaic4
                partners = [int(idx)] + [int(i) for i in
                                         item_rng.integers(0, len(self.ds), 3)]
                items = [self.ds.load_item(i, target_hw=hw) for i in partners]
                img, lab = mosaic4(items, hw[0], item_rng)
            else:
                img, lab = self.ds.load_item(int(idx), target_hw=hw)
            if self.hsv:
                from yolov5m_tpu_torch.data.augment import augment_hsv
                img = augment_hsv(img, item_rng)
            if self.augment is not None:
                img, lab = self.augment(img, lab, batch_idx=batch_idx,
                                        rng=item_rng)
            n = min(len(lab), nb)
            imgs[j] = img
            if n:
                labels[j, :n] = lab[:n]
                mask[j, :n] = True
        return {"image": imgs / 255.0, "labels": labels, "mask": mask,
                "image_valid": image_valid, "orig_hw": orig_hw}
