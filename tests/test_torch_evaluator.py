"""The port's evaluator (yolov5m_tpu_torch/eval/) against the JAX one.

  * The numpy copies (MeanAveragePrecision, ConfusionMatrix, CocoDump)
    give exactly the JAX package's dicts, matrices and file bytes on the
    same numpy detections.
  * Evaluator.run on the same synthetic scenes with the flagship weights
    (full width, BN live on both sides and folded by each evaluator), f32
    at 256 px on the CPU: the accuracy counts must be equal, and map50,
    map75 and map within 0.02 of JAX (both run f32 convolutions in another
    summation order, so a detection near the NMS or matching threshold may
    land on the other side; measured difference 0.0 on these scenes).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from yolov5m_tpu.config import Config as JConfig
from yolov5m_tpu.eval import Evaluator as JEvaluator
from yolov5m_tpu.eval.coco_dump import CocoDump as JCocoDump
from yolov5m_tpu.eval.confusion import ConfusionMatrix as JConfusion
from yolov5m_tpu.eval.metrics import MeanAveragePrecision as JMAP
from yolov5m_tpu.models import YOLOv5 as JYOLOv5
from yolov5m_tpu_torch.config import Config
from yolov5m_tpu_torch.data.synthetic import synth_batch
from yolov5m_tpu_torch.eval.coco_dump import CocoDump
from yolov5m_tpu_torch.eval.confusion import ConfusionMatrix
from yolov5m_tpu_torch.eval.evaluator import Evaluator
from yolov5m_tpu_torch.eval.metrics import MeanAveragePrecision
from yolov5m_tpu_torch.models.weights import read_flagship, state_dict_from_flax
from yolov5m_tpu_torch.models.yolo import YOLOv5, normalized_anchors

torch.set_num_threads(1)

MAP_TOL = 0.02


def _detections(seed, n_images=12, nc=4):
    """Per-image (preds, targets) dicts: detections near the GT with noise,
    some false positives, some empty images, some tiny and huge boxes."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_images):
        m = int(rng.integers(0, 6)) if i % 5 else 0
        xy = rng.uniform(0, 500, (m, 2))
        wh = rng.choice([8.0, 60.0, 200.0], (m, 1)) * rng.uniform(0.5, 1.5, (m, 2))
        gt = np.concatenate([xy, xy + wh], 1).astype(np.float32)
        gl = rng.integers(0, nc, m)
        keep = rng.uniform(0, 1, m) < 0.8
        det = gt[keep] + rng.normal(0, 3, (int(keep.sum()), 4)).astype(np.float32)
        dl = np.where(rng.uniform(0, 1, len(det)) < 0.85, gl[keep],
                      rng.integers(0, nc, len(det)))
        fp = int(rng.integers(0, 4))
        fxy = rng.uniform(0, 500, (fp, 2))
        det = np.concatenate([det, np.concatenate([fxy, fxy + 40], 1)]).astype(np.float32)
        dl = np.concatenate([dl, rng.integers(0, nc, fp)])
        scores = rng.uniform(0.01, 1, len(det)).astype(np.float32)
        out.append((dict(boxes=det, scores=scores, labels=dl.astype(np.float32)),
                    dict(boxes=gt, labels=gl.astype(np.float32))))
    return out


@pytest.mark.parametrize("max_det,area_scale", [(None, 1.0), (2, 2.25)])
def test_map_equals_jax(max_det, area_scale):
    mine, theirs = MeanAveragePrecision(max_det=max_det), JMAP(max_det=max_det)
    assert mine.compute() == theirs.compute()       # the empty sentinels
    for preds, targets in _detections(0):
        mine.update(preds, targets, area_scale=area_scale)
        theirs.update(preds, targets, area_scale=area_scale)
    got, want = mine.compute(), theirs.compute()
    assert got == want
    assert 0 < got["map_50"] < 1


def test_confusion_and_coco_dump_equal_jax(tmp_path):
    mine, theirs = ConfusionMatrix(4), JConfusion(4)
    dm, dt = CocoDump(["a", "b", "c", "d"]), JCocoDump(["a", "b", "c", "d"])
    for i, (preds, targets) in enumerate(_detections(1)):
        mine.update(preds, targets)
        theirs.update(preds, targets)
        args = (i, 640, 480, preds["boxes"], preds["scores"],
                preds["labels"], targets["boxes"], targets["labels"])
        dm.add_image(*args)
        dt.add_image(*args)
    np.testing.assert_array_equal(mine.matrix, theirs.matrix)
    for k, v in mine.per_class().items():
        np.testing.assert_array_equal(v, theirs.per_class()[k])
    mine.save_csv(str(tmp_path / "m.csv"), ["a", "b"])
    theirs.save_csv(str(tmp_path / "t.csv"), ["a", "b"])
    assert (tmp_path / "m.csv").read_bytes() == (tmp_path / "t.csv").read_bytes()
    pm, pt = dm.write(str(tmp_path / "m")), dt.write(str(tmp_path / "t"))
    for key in ("annotations", "results"):
        with open(pm[key], "rb") as f, open(pt[key], "rb") as g:
            assert f.read() == g.read()


def _scenes(n_batches=2, bs=2, hw=256):
    gen = torch.Generator().manual_seed(3)
    out = []
    for _ in range(n_batches):
        img, labels, mask = synth_batch(gen, bs, hw, 80)
        out.append({"image": img.numpy(), "labels": labels.numpy(),
                    "mask": mask.numpy()})
    return out


@pytest.fixture(scope="module")
def flagship():
    variables, _ = read_flagship()
    return variables


def test_evaluator_run_matches_jax(flagship, tmp_path):
    batches = _scenes()
    jcfg, cfg = JConfig(), Config()
    jmodel = JYOLOv5(first_out=48, nc=80)
    want = JEvaluator(jmodel, normalized_anchors(), jcfg).run(
        jax.tree.map(np.asarray, flagship), batches)

    model = YOLOv5(first_out=48, nc=80)
    sd = {k: torch.from_numpy(v) for k, v in
          state_dict_from_flax(flagship).items()}
    model.load_state_dict(sd, strict=True)
    ev = Evaluator(model, normalized_anchors(), cfg)
    got = ev.run(sd, [{**b, "image": torch.from_numpy(b["image"])}
                      for b in batches],
                 coco_dump_dir=str(tmp_path / "coco"),
                 class_names=["c"] * 80,
                 confusion_csv=str(tmp_path / "cm.csv"))
    assert set(got) == set(want)
    assert got["class_accuracy"] == want["class_accuracy"]
    assert got["obj_accuracy"] == want["obj_accuracy"]
    for k in ("map50", "map75", "map"):
        assert abs(got[k] - want[k]) <= MAP_TOL, (k, got[k], want[k])
    assert got["map50"] > 0.3           # the flagship finds the scenes
    assert ev.timing["images"] == 4
    with open(os.path.join(tmp_path, "coco", "results.json")) as f:
        assert len(json.load(f)) > 0
    assert (tmp_path / "cm.csv").read_text().startswith("pred\\true,")

    # without the depth-1 overlap: the same dict
    serial = Evaluator(model, normalized_anchors(), cfg, overlap=False).run(
        sd, [{**b, "image": torch.from_numpy(b["image"])} for b in batches])
    assert serial == got


def test_evaluator_skips_invalid_rows_and_scales_areas(flagship):
    """image_valid false rows are skipped; orig_hw rescales area buckets
    only (the 'all' numbers do not move)."""
    batches = _scenes(n_batches=1)
    sd = {k: torch.from_numpy(v) for k, v in
          state_dict_from_flax(flagship).items()}
    model = YOLOv5(first_out=48, nc=80)
    ev = Evaluator(model, normalized_anchors(), Config())
    b = {**batches[0], "image": torch.from_numpy(batches[0]["image"])}
    one = ev.run(sd, [{**b, "image_valid": np.array([True, False])}])
    assert ev.timing["images"] == 2
    only_first = ev.run(sd, [{k: v[:1] for k, v in b.items()}])
    # the accuracy counts cover every row, as in the JAX evaluator (a
    # padded row is a blank image without labels); mAP skips the row
    for k in ("map50", "map75", "map", "ap_per_class"):
        assert one[k] == only_first[k], k
    scaled = ev.run(sd, [{**b, "orig_hw": np.array([[512, 512]] * 2)}])
    plain = ev.run(sd, [b])
    assert scaled["map50"] == plain["map50"]
    assert scaled["map_large"] != plain["map_large"] \
        or scaled["map_small"] != plain["map_small"]



def test_evaluator_takes_the_model_with_batchnorm():
    with pytest.raises(ValueError, match="fused=False"):
        Evaluator(YOLOv5(first_out=8, nc=3, depth_mult=0.33, fused=True),
                  normalized_anchors(), Config(nc=3))
