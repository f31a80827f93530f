"""Small disk datasets for the port's data tests: images under
{root}/images/{split} and txt labels under {root}/labels/{split}, made from
a seed with numpy.

Each image is noise with a few flat rectangles (the labelled objects), so
resizes, flips and mosaics have edges to move. ``fmt`` picks the file
format: "png" (through PIL) or "ppm" (the port's numpy encoder); the same
seed gives the same pixels and labels in either format."""

import os

import numpy as np

SIZES = ((48, 64), (64, 48), (80, 72), (64, 64), (56, 96))


def _image_and_boxes(rng, h, w, nc, n_boxes):
    img = rng.integers(0, 80, (h, w, 3), np.uint8)
    boxes = []
    for _ in range(n_boxes):
        bw = rng.uniform(6, w / 2)
        bh = rng.uniform(6, h / 2)
        x1 = rng.uniform(0, w - bw)
        y1 = rng.uniform(0, h - bh)
        cls = int(rng.integers(0, nc))
        color = rng.integers(100, 256, 3)
        img[int(y1):int(y1 + bh), int(x1):int(x1 + bw)] = color
        boxes.append((cls, x1, y1, bw, bh))
    return img, boxes


def _label_lines(boxes, h, w, box_format):
    lines = []
    for cls, x1, y1, bw, bh in boxes:
        if box_format == "coco":          # x1 y1 w h in pixels, 1-indexed
            lines.append(f"{x1:.2f} {y1:.2f} {bw:.2f} {bh:.2f} {cls + 1}")
        else:                             # cls cx cy w h, normalized
            lines.append(f"{cls} {(x1 + bw / 2) / w:.6f} "
                         f"{(y1 + bh / 2) / h:.6f} {bw / w:.6f} {bh / h:.6f}")
    return lines


def write_image(path, img, fmt):
    if fmt == "ppm":
        from yolov5m_tpu_torch.data.native import encode_ppm
        with open(path, "wb") as f:
            f.write(encode_ppm(img))
    else:
        from PIL import Image
        Image.fromarray(img).save(path)


def write_dataset(root, fmt="png", box_format="coco", n_train=10, n_val=5,
                  nc=3, seed=0):
    """Write the dataset under root; returns root. Image i of a split has
    size SIZES[i % len(SIZES)] and 0-4 boxes; the first train label file
    also holds a row with a negative value (dropped on load), and the last
    train image has an empty label file."""
    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        os.makedirs(os.path.join(root, "images", split), exist_ok=True)
        os.makedirs(os.path.join(root, "labels", split), exist_ok=True)
        for i in range(n):
            h, w = SIZES[i % len(SIZES)]
            n_boxes = 0 if (split == "train" and i == n - 1) \
                else int(rng.integers(1, 5))
            img, boxes = _image_and_boxes(rng, h, w, nc, n_boxes)
            write_image(os.path.join(root, "images", split,
                                     f"img{i:02d}.{fmt}"), img, fmt)
            lines = _label_lines(boxes, h, w, box_format)
            if split == "train" and i == 0:
                lines.append("-1 0.5 0.5 0.1 0.1")
            with open(os.path.join(root, "labels", split,
                                   f"img{i:02d}.txt"), "w") as f:
                f.write("\n".join(lines))
    return root


def write_thin_labels(root, split="train", seed=4):
    """Rewrite the split's coco labels as tall thin boxes (w/h about
    1/12), which no default anchor covers within the ratio gate of 4, so
    that autoanchor refits."""
    rng = np.random.default_rng(seed)
    folder = os.path.join(root, "labels", split)
    for name in sorted(os.listdir(folder)):
        rows = []
        for _ in range(int(rng.integers(2, 6))):
            w, h = rng.uniform(1.5, 3.0), rng.uniform(30.0, 40.0)
            rows.append(f"{rng.uniform(0, 10):.2f} {rng.uniform(0, 10):.2f} "
                        f"{w:.2f} {h:.2f} {int(rng.integers(1, 4))}")
        with open(os.path.join(folder, name), "w") as f:
            f.write("\n".join(rows))
