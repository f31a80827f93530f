"""The port's autoanchor (yolov5m_tpu_torch/data/autoanchor.py) and COCO
label preparation (data/coco_prep.py) against the JAX package's: the same
box statistics, BPR and fitted anchors EXACTLY, on disk datasets read by
each package's own DetectionDataset (one whose boxes the default anchors
cover, one they do not), and the same label files from one instances
JSON."""

import json

import numpy as np
import pytest

from tests.torch_datasets import write_dataset, write_thin_labels
from yolov5m_tpu.config import ANCHORS
from yolov5m_tpu.data import autoanchor as jaa
from yolov5m_tpu.data import coco_prep as jprep
from yolov5m_tpu.data.dataset import DetectionDataset as JDataset
from yolov5m_tpu_torch.data import autoanchor as aa
from yolov5m_tpu_torch.data import coco_prep as prep
from yolov5m_tpu_torch.data.dataset import DetectionDataset


@pytest.mark.parametrize("kind", ["covered", "refit"])
def test_check_and_fit_equals_jax(kind, tmp_path):
    root = write_dataset(str(tmp_path / "d"), "png", n_train=12)
    if kind == "refit":
        write_thin_labels(root)
    ds = DetectionDataset(root, default_size=640)
    jds = JDataset(root, default_size=640)
    np.testing.assert_array_equal(aa.collect_wh(ds, 640),
                                  jaa.collect_wh(jds, 640))
    anchors = np.asarray(ANCHORS, np.float32)
    got, info = aa.check_and_fit(ds, anchors, image_size=640)
    want, jinfo = jaa.check_and_fit(jds, anchors, image_size=640)
    np.testing.assert_array_equal(got, want)
    assert info == jinfo
    assert info["refit"] == (kind == "refit")
    assert got.shape == (3, 3, 2) and got.dtype == np.float32


def test_fit_and_bpr_equal_jax():
    rng = np.random.default_rng(0)
    wh = np.exp(rng.normal(3.5, 0.8, (500, 2)))
    np.testing.assert_array_equal(aa.fit_anchors(wh, 9),
                                  jaa.fit_anchors(wh, 9))
    anchors = np.asarray(ANCHORS, np.float32).reshape(-1, 2)
    assert aa.best_possible_recall(wh, anchors) == \
        jaa.best_possible_recall(wh, anchors)
    with pytest.raises(ValueError, match="no labels"):
        class Empty:
            def __len__(self):
                return 1

            def load_labels(self, i):
                return np.zeros((0, 5), np.float32)
        aa.collect_wh(Empty())


def test_coco_prep_equals_jax(tmp_path):
    data = {"images": [{"id": 1, "file_name": "a.jpg"},
                       {"id": 2, "file_name": "b.png"}],
            "annotations": [
                {"image_id": 1, "bbox": [1.5, 2.25, 30, 40], "category_id": 13},
                {"image_id": 1, "bbox": [0, 0, 0, 5], "category_id": 1},
                {"image_id": 2, "bbox": [5, 6, 7, 8], "category_id": 90,
                 "iscrowd": 0},
                {"image_id": 2, "bbox": [5, 6, 7, 8], "category_id": 3,
                 "iscrowd": 1}]}
    path = tmp_path / "instances.json"
    path.write_text(json.dumps(data))
    for keep_91 in (False, True):
        out, jout = tmp_path / f"p{keep_91}", tmp_path / f"j{keep_91}"
        n = prep.convert_instances(str(path), str(out), map_to_80=not keep_91)
        assert n == jprep.convert_instances(str(path), str(jout),
                                            map_to_80=not keep_91) == 2
        for name in ("a.txt", "b.txt"):
            assert (out / name).read_text() == (jout / name).read_text()
    assert [prep.coco91_to_coco80(c) for c in range(1, 91)] == \
        [jprep.coco91_to_coco80(c) for c in range(1, 91)]
