"""On-device synthetic detection data: class-colored rectangles on noise.

Port of ``yolov5m_tpu/data/synthetic.py`` (``class_palette``,
``synth_batch``, ``SyntheticLoader``). The committed flagship weights were
trained on this distribution, so it is the in-distribution load for
serving measurements, and ``--data synth`` trains and evaluates on it.
Random numbers come from an explicit ``torch.Generator`` on the device:
the JAX key stream cannot be reproduced, the distribution is the same.
"""

from __future__ import annotations

import numpy as np
import torch


def class_palette(nc: int) -> np.ndarray:
    """(nc, 3) deterministic, pairwise-distinct RGB colors in [0.15, 0.95].
    Channel 0 uses a multiplier coprime with nc, so it alone separates the
    classes."""
    i = np.arange(nc)
    m0 = 37 if np.gcd(37, max(nc, 1)) == 1 else 1
    r = ((i * m0) % nc) / max(nc - 1, 1)
    g = ((i * 53 + 11) % nc) / max(nc - 1, 1)
    b = ((i * 71 + 29) % nc) / max(nc - 1, 1)
    return (np.stack([r, g, b], axis=-1) * 0.8 + 0.15).astype(np.float32)


def synth_batch(generator: torch.Generator, bs: int, hw: int, nc: int,
                max_boxes: int = 8, noise: float = 0.25):
    """Batch of structured detection images on ``generator``'s device.

    Returns (images (bs, hw, hw, 3) f32 in [0, 1],
             labels (bs, max_boxes, 5) [cls, cx, cy, w, h] normalized,
             mask   (bs, max_boxes) bool).
    Boxes are painted in order, so a later box may occlude an earlier one."""
    dev = generator.device
    kw = dict(generator=generator, device=dev)
    palette = torch.from_numpy(class_palette(nc)).to(dev)

    cls = torch.randint(0, nc, (bs, max_boxes), **kw)
    wh = 0.06 + (0.42 - 0.06) * torch.rand((bs, max_boxes, 2), **kw)
    u = torch.rand((bs, max_boxes, 2), **kw)
    cxy = wh / 2 + u * (1.0 - wh)          # the whole box inside the image
    n_boxes = torch.randint(1, max_boxes + 1, (bs,), **kw)
    mask = torch.arange(max_boxes, device=dev)[None, :] < n_boxes[:, None]

    amp = 0.5 + 0.5 * torch.rand((bs, 1, 1, 1), **kw)
    img = torch.rand((bs, hw, hw, 3), **kw) * noise * amp

    c = (torch.arange(hw, dtype=torch.float32, device=dev) + 0.5) / hw
    ys, xs = c[None, :, None], c[None, None, :]
    half = wh / 2
    x1, y1 = cxy[..., 0] - half[..., 0], cxy[..., 1] - half[..., 1]
    x2, y2 = cxy[..., 0] + half[..., 0], cxy[..., 1] + half[..., 1]
    for k in range(max_boxes):
        inside = ((ys >= y1[:, k, None, None]) & (ys < y2[:, k, None, None])
                  & (xs >= x1[:, k, None, None]) & (xs < x2[:, k, None, None])
                  & mask[:, k, None, None])
        color = palette[cls[:, k]][:, None, None, :]     # (bs, 1, 1, 3)
        img = torch.where(inside[..., None], color, img)

    labels = torch.cat([cls[..., None].float(), cxy, wh], -1)
    labels = labels * mask[..., None]
    return img, labels, mask


def to_uint8(images: torch.Tensor) -> torch.Tensor:
    """[0, 1] float frames -> uint8 codes, round(x * 255): what a camera or
    decoder delivers for the same scenes."""
    return torch.round(images * 255).to(torch.uint8)


class SyntheticLoader:
    """Iterable over synthetic batches generated on ``device``: the train
    CLI's and the evaluator's loader for ``--data synth``. Yields
    ``{"image", "labels", "mask"}`` dicts, the image on the device and
    labels/mask as numpy (the evaluator's host matcher indexes them per
    image); supports ``len()`` and ``set_epoch()``.

    train=True: batches differ with (epoch, step), and the size cycles
    through the sorted ``multi_scale_sizes`` as ``sizes[(-1 - i) % n]``
    (largest first). train=False: a fixed eval set at the largest size,
    whose seeds depend only on the step index. Each batch has its own
    ``torch.Generator`` seeded from (seed, epoch, step); the stream is not
    the JAX package's, the distribution is.

    rank, world_size: data parallelism. Each step still draws the global
    batch of ``batch_size`` from its generator and yields rows
    [rank*per, (rank+1)*per) of it, so the ranks' rows together are the
    single-process batch."""

    def __init__(self, batch_size: int, steps: int, image_size: int = 640,
                 nc: int = 80, max_boxes: int = 8, seed: int = 0,
                 train: bool = True, multi_scale_sizes=None,
                 device="cuda", rank: int = 0, world_size: int = 1):
        if batch_size % world_size:
            raise ValueError(f"batch size {batch_size} is not divisible by "
                             f"{world_size} ranks")
        per = batch_size // world_size
        self.rows = slice(rank * per, (rank + 1) * per)
        self.bs = batch_size
        self.steps = steps
        self.nc = nc
        self.max_boxes = max_boxes
        self.seed = seed
        self.train = train
        self.sizes = (sorted(multi_scale_sizes) if multi_scale_sizes
                      else [image_size])
        self.device = torch.device(device)
        self._epoch = 0

    def __len__(self) -> int:
        return self.steps

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    def batch_seed(self, i: int) -> int:
        """The seed of batch i, hashed from (seed, stream, epoch, i): train
        batches depend on (epoch, i), eval batches on i alone. Hashed so
        that the low 32 bits, all a CPU generator keeps, differ too."""
        key = ([self.seed, 0, self._epoch, i] if self.train
               else [self.seed, 1, 0, i])
        return int(np.random.SeedSequence(key).generate_state(1, np.uint64)[0]
                   >> np.uint64(1))

    def __iter__(self):
        for i in range(self.steps):
            size = (self.sizes[(-1 - i) % len(self.sizes)] if self.train
                    else self.sizes[-1])
            gen = torch.Generator(device=self.device)
            gen.manual_seed(self.batch_seed(i))
            img, labels, mask = (t[self.rows] for t in synth_batch(
                gen, self.bs, size, self.nc, max_boxes=self.max_boxes))
            yield {"image": img, "labels": labels.cpu().numpy(),
                   "mask": mask.cpu().numpy()}
