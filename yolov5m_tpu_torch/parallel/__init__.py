"""Data parallelism for training and serving: port of ``yolov5m_tpu/parallel/``
(``dp.py`` and ``infer.py``; SP, TP and PP are not ported yet)."""

from yolov5m_tpu_torch.parallel.dp import (initialize_multihost,
                                           local_batch_slice,
                                           make_dp_train_step, make_mesh,
                                           replicate_state)
from yolov5m_tpu_torch.parallel.infer import make_dp_infer_fn

__all__ = ["initialize_multihost", "local_batch_slice", "make_dp_infer_fn",
           "make_dp_train_step", "make_mesh", "replicate_state"]
