"""COCO JSON → txt-label dataset preparation.

A working implementation of the reference's coco.py, whose conversion
scripts exist only inside comments/docstrings (reference coco.py:1-80).
Produces the directory layout the datasets expect:

  {root}/labels/{split}/{image_stem}.txt   rows: "x1 y1 w h cls"
                                           (coco pixels, 1-indexed class —
                                           the format dataset.py:88-102 reads)

Usage:
  python -m yolov5m_tpu_torch.data.coco_prep instances_val2017.json labels/val

An own copy of ``yolov5m_tpu/data/coco_prep.py`` (stdlib only).
"""

from __future__ import annotations

import argparse
import json
import os
from collections import defaultdict


def coco91_to_coco80(cat_id: int) -> int:
    """Map a COCO 91-category id to the contiguous 80-class index + 1
    (1-indexed, matching the reference label files). Same mapping as
    reference utils/utils.py:89-116."""
    missing = (12, 26, 29, 30, 45, 66, 68, 69, 71, 83, 91)
    shift = sum(1 for m in missing if cat_id > m)
    return cat_id - shift


def convert_instances(json_path: str, out_dir: str,
                      map_to_80: bool = True) -> int:
    """Write one txt per annotated image. Returns image count."""
    with open(json_path) as f:
        data = json.load(f)

    images = {im["id"]: im for im in data["images"]}
    per_image = defaultdict(list)
    for ann in data["annotations"]:
        if ann.get("iscrowd", 0):
            continue
        x, y, w, h = ann["bbox"]
        if w <= 0 or h <= 0:
            continue
        cid = ann["category_id"]
        cls = coco91_to_coco80(cid) if map_to_80 else cid
        per_image[ann["image_id"]].append(f"{x:.2f} {y:.2f} {w:.2f} {h:.2f} {cls}")

    os.makedirs(out_dir, exist_ok=True)
    for img_id, lines in per_image.items():
        stem = os.path.splitext(images[img_id]["file_name"])[0]
        with open(os.path.join(out_dir, stem + ".txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    return len(per_image)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("json_path")
    p.add_argument("out_dir")
    p.add_argument("--keep-91", action="store_true",
                   help="keep original 91-category ids")
    args = p.parse_args()
    n = convert_instances(args.json_path, args.out_dir,
                          map_to_80=not args.keep_91)
    print(f"wrote labels for {n} images to {args.out_dir}")


if __name__ == "__main__":
    main()
