"""Parallelism: port of ``yolov5m_tpu/parallel/``.

Data parallelism (``dp.py``, ``infer.py``) runs one process a device.
Spatial (``sp.py``), tensor (``tp.py``) and pipeline (``pp.py``)
parallelism run one process over a grid of devices (``mesh.py``,
``grid.py``), composing with a data axis on the same grid."""

from yolov5m_tpu_torch.parallel.dp import (initialize_multihost,
                                           local_batch_slice,
                                           make_dp_train_step, make_mesh,
                                           replicate_state)
from yolov5m_tpu_torch.parallel.infer import make_dp_infer_fn
from yolov5m_tpu_torch.parallel.mesh import (Mesh, make_dp_pp_mesh,
                                             make_mesh2d, make_pp_mesh,
                                             make_sp_mesh, make_tp_mesh,
                                             resolve_data_axis)
from yolov5m_tpu_torch.parallel.pp import (make_pp_infer_fn,
                                           make_pp_train_step)
from yolov5m_tpu_torch.parallel.sp import make_sp_infer_fn, make_sp_train_step
from yolov5m_tpu_torch.parallel.tp import (make_tp_infer_fn,
                                           make_tp_train_step, shard_state_tp,
                                           shard_variables_tp)

__all__ = ["Mesh", "initialize_multihost", "local_batch_slice",
           "make_dp_infer_fn", "make_dp_pp_mesh", "make_dp_train_step",
           "make_mesh", "make_mesh2d", "make_pp_infer_fn", "make_pp_mesh",
           "make_pp_train_step", "make_sp_infer_fn", "make_sp_mesh",
           "make_sp_train_step", "make_tp_infer_fn", "make_tp_mesh",
           "make_tp_train_step", "replicate_state", "resolve_data_axis",
           "shard_state_tp", "shard_variables_tp"]
