"""Device grids for SP, TP and PP: the port's counterpart of
``jax.sharding.Mesh`` and of ``yolov5m_tpu/parallel/dp.py:make_mesh2d`` and
``resolve_data_axis``.

A ``Mesh`` names the axes of an array of ``torch.device``. One process
drives every device of it (``parallel/grid.py``): the batch, the image rows,
the channels or the model's stages are split over the axes, and activations
move between devices by copies. A grid may name one device more than once
(several cells on one card, or ``["cpu"] * n`` on the host); its cells then
share that device.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch


class Mesh:
    """``devices``: a nested sequence of devices (``torch.device`` or
    strings), one dimension an axis; ``axis_names``: the axes' names,
    major first. ``shape`` maps a name to its size, as ``jax`` does."""

    def __init__(self, devices, axis_names: Sequence[str]):
        grid = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if grid.ndim != len(axis_names):
            raise ValueError(f"a {grid.ndim}-D device array needs "
                             f"{grid.ndim} axis names, got {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"axis names repeat: {axis_names}")
        self.devices = np.empty(grid.shape, dtype=object)
        for idx in np.ndindex(grid.shape):
            self.devices[idx] = torch.device(grid[idx])
        kinds = {d.type for d in self.devices.flat}
        if len(kinds) != 1:
            raise ValueError(f"a mesh needs devices of one kind, got {kinds}")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, grid.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def grid(self, major: Optional[str], minor: str):
        """The devices as rows over ``major`` and columns over ``minor``: a
        list of lists. With ``major`` None the batch is not sharded: one
        row, the devices along ``minor`` at index 0 of the other axes (a
        replicated batch is computed once)."""
        if major is None:
            idx = tuple(slice(None) if a == minor else 0
                        for a in self.axis_names)
            return [list(self.devices[idx])]
        order = [self.axis_names.index(major), self.axis_names.index(minor)]
        return [list(row) for row in np.transpose(self.devices, order)]


def _devices(n: int, device: str) -> list:
    """n devices of ``device``'s kind: the first n cards, or n entries of
    the host device. Never truncates: more than exist raises."""
    kind = torch.device(device).type
    if kind == "cuda":
        have = torch.cuda.device_count()
        if have < n:
            raise ValueError(f"need {n} devices, have {have} cuda devices")
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device(kind)] * n


def make_mesh2d(n_major: int, n_minor: int, major_axis: str, minor_axis: str,
                device: str = "cuda", devices=None) -> Mesh:
    """The 2-D grid behind make_sp_mesh, make_tp_mesh and make_dp_pp_mesh.

    The minor axis is the fastest-varying one, as in JAX, so that its
    per-layer traffic (halo rows, channel gathers, stage hand-offs) goes
    between neighbouring cards; the major axis carries only per-step
    reductions. ``devices`` (n_major * n_minor entries, flat or nested)
    overrides the first cards, and may repeat one."""
    n = n_major * n_minor
    if devices is None:
        flat = _devices(n, device)
    else:
        flat = list(np.asarray(devices, dtype=object).reshape(-1))
        if len(flat) != n:
            raise ValueError(f"a {n_major}x{n_minor} mesh needs {n} devices, "
                             f"got {len(flat)}")
    grid = [flat[r * n_minor:(r + 1) * n_minor] for r in range(n_major)]
    return Mesh(grid, (major_axis, minor_axis))


def resolve_data_axis(data_axis: Optional[str], mesh: Mesh,
                      reserved: Tuple[str, ...] = ()) -> Optional[str]:
    """Validate an optional batch-sharding axis against the mesh.

    The default name "data" falls back to None on a 1-D mesh without it
    (pure SP or TP); any other miss raises, because replicating the batch
    would give 1/n_data of the expected rate without a word. ``reserved``
    names the compute axis, which the batch must not alias."""
    if data_axis is not None and data_axis in reserved:
        raise ValueError(f"data_axis {data_axis!r} is this mesh's compute "
                         f"axis; sharding the batch over it would corrupt "
                         f"results")
    if data_axis is None or data_axis in mesh.axis_names:
        return data_axis
    if data_axis == "data" and len(mesh.axis_names) == 1:
        return None
    raise ValueError(f"data_axis {data_axis!r} is not one of this mesh's axes "
                     f"{mesh.axis_names}; pass None to replicate the batch "
                     f"instead")


def make_sp_mesh(n_data: int = 1, n_spatial: int = 2, data_axis: str = "data",
                 spatial_axis: str = "spatial", device: str = "cuda",
                 devices=None) -> Mesh:
    """A (data, spatial) grid: image rows over the spatial axis."""
    return make_mesh2d(n_data, n_spatial, data_axis, spatial_axis, device,
                       devices)


def make_tp_mesh(n_data: int = 1, n_model: int = 2, data_axis: str = "data",
                 model_axis: str = "model", device: str = "cuda",
                 devices=None) -> Mesh:
    """A (data, model) grid: output channels over the model axis."""
    return make_mesh2d(n_data, n_model, data_axis, model_axis, device,
                       devices)


def make_pp_mesh(n_pipe: int = 4, pipe_axis: str = "pipe",
                 device: str = "cuda", devices=None) -> Mesh:
    """A 1-D pipeline: stage s on the s-th device."""
    if devices is None:
        devices = _devices(n_pipe, device)
    elif len(devices) != n_pipe:
        raise ValueError(f"{n_pipe} stages need {n_pipe} devices, got "
                         f"{len(devices)}")
    return Mesh(list(devices), (pipe_axis,))


def make_dp_pp_mesh(n_data: int = 2, n_pipe: int = 4, data_axis: str = "data",
                    pipe_axis: str = "pipe", device: str = "cuda",
                    devices=None) -> Mesh:
    """A (data, pipe) grid: n_data replicas, each an n_pipe-stage
    pipeline."""
    return make_mesh2d(n_data, n_pipe, data_axis, pipe_axis, device, devices)
