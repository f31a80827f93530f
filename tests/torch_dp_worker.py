"""One rank of the port's data-parallel trainer, for tests/test_torch_dp.py.

    python tests/torch_dp_worker.py RANK WORLD PORT INPUT OUTPUT

Joins a gloo group on 127.0.0.1:PORT through
``parallel.dp.initialize_multihost``, reads INPUT (torch.save of
{"state_dict", "batches", "cases", "nc", "hw"}), and for every case builds
YOLOv5(first_out 8, depth 0.33) from the state dict, makes the DP trainer
with ``make_dp_train_step`` and runs this rank's rows
(``local_batch_slice``) of the case's global batches. Writes
OUTPUT.RANK: per case, the metrics of every micro-batch, the model's state
dict, the EMA state dict and the optimizer's update count.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def run_case(case: dict, data: dict) -> dict:
    import torch.distributed as dist

    from yolov5m_tpu_torch.config import ANCHORS, Config
    from yolov5m_tpu_torch.models.yolo import YOLOv5
    from yolov5m_tpu_torch.parallel.dp import (local_batch_slice,
                                               make_dp_train_step)
    from yolov5m_tpu_torch.train.loss import LossConfig, YoloLoss
    from yolov5m_tpu_torch.train.trainer import YoloAdam

    nc, hw = data["nc"], data["hw"]
    model = YOLOv5(first_out=8, nc=nc, depth_mult=0.33,
                   bn_group=dist.group.WORLD if case["sync_bn"] else None,
                   remat=case.get("remat", False), remat_scope="all")
    model.load_state_dict(data["state_dict"], strict=True)
    cfg = Config(first_out=8, nc=nc, image_size=hw)
    loss_fn = YoloLoss(LossConfig(nc=nc, image_size=hw),
                       np.asarray(ANCHORS, np.float32), kind=case["kind"])
    trainer = make_dp_train_step(model, loss_fn,
                                 YoloAdam(model.parameters(), cfg),
                                 case["accumulate"])
    metrics = []
    for image, labels, mask in data["batches"][:case["steps"]]:
        rows = local_batch_slice(image.shape[0])
        m = trainer.train_step(image[rows], labels[rows], mask[rows])
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics,
            "state": {k: v.clone() for k, v in model.state_dict().items()},
            "ema": {k: v.clone() for k, v in
                    trainer.eval_state_dict().items()},
            "count": trainer.optimizer.param_groups[0]["count"]}


def main(argv) -> None:
    import torch.distributed as dist

    from yolov5m_tpu_torch.parallel.dp import initialize_multihost

    rank, world, port = (int(a) for a in argv[:3])
    inp, out = argv[3:5]
    torch.set_num_threads(1)
    initialize_multihost(f"127.0.0.1:{port}", world, rank, backend="gloo")
    try:
        data = torch.load(inp, weights_only=False)
        results = {c["name"]: run_case(c, data) for c in data["cases"]}
        torch.save(results, f"{out}.{rank}")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
