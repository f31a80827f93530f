"""The port's NMS (yolov5m_tpu_torch/ops/nms.py) against the JAX package's.

Same numpy inputs through JAX ``suppress`` (backends "xla", "xla_loop"
and "pallas" in interpret mode), the port's plain backends ("torch",
"torch_loop") and ``greedy_keep_tiled_plain``, which follows the CUDA
kernel's tiled order. Keep masks and compacted detections must be
exactly equal: both sides run the same f32 operations in the same order.

The JAX package is imported inside the tests that use it, so the CUDA
cases also run on a GPU machine without JAX:
    python -m pytest tests/test_torch_nms.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from yolov5m_tpu_torch.ops import nms as tnms
from yolov5m_tpu_torch.ops.cuda import nms_kernel

torch.set_num_threads(1)

CASES = ("dense", "ties", "many", "invalid", "chain")
# the kernel's tests add a valid mask with holes and IoUs at the threshold
NEW_CASES = CASES + ("holes", "grid")


def _rows(case: str, bs: int, k: int, seed: int = 0):
    """(rows (bs, k, 6) [class, conf, cx, cy, w, h] f32, conf gate, iou t)."""
    rng = np.random.default_rng(seed)
    if case == "chain":
        # box i overlaps only i-1 and i+1 (IoU .43), scores descending:
        # greedy keeps exactly the evens
        i = np.arange(k)
        one = np.stack([np.zeros(k), 1.0 - i / (2 * k), 20.0 * i + 25.0,
                        np.full(k, 100.0), np.full(k, 50.0),
                        np.full(k, 50.0)], -1)
        return np.repeat(one[None], bs, 0).astype(np.float32), 0.01, 0.3
    if case == "grid":
        # integer centres and sizes: corners on a half-pixel grid, so many
        # pairs have IoU within a few ulps of t (decisions at the edge)
        cxy = rng.integers(0, 9, (bs, k, 2))
        wh = rng.integers(1, 7, (bs, k, 2))
        cls = rng.integers(0, 2, (bs, k))
        conf = rng.uniform(0, 1, (bs, k))
        rows = np.concatenate([cls[..., None], conf[..., None], cxy, wh], -1)
        return rows.astype(np.float32), 0.25, 0.5
    nc = {"dense": 2, "ties": 3, "many": 80, "invalid": 5}[case]
    centers = rng.uniform(100, 540, (bs, 12, 2))
    pick = rng.integers(0, 12, (bs, k))
    cxy = np.take_along_axis(centers, pick[..., None], 1) + rng.normal(
        0, 12, (bs, k, 2))
    wh = rng.uniform(40, 120, (bs, k, 2))
    cls = rng.integers(0, nc, (bs, k))
    conf = rng.uniform(0, 1, (bs, k))
    if case == "ties":
        conf = rng.integers(1, 5, (bs, k)) / 5.0      # many exact ties
    if case == "invalid":
        conf = np.zeros((bs, k))
    rows = np.concatenate([cls[..., None], conf[..., None], cxy, wh], -1)
    return rows.astype(np.float32), 0.25, 0.5


@pytest.fixture
def jnms():
    from yolov5m_tpu.ops import nms
    return nms


def _jax_candidates(jnms, rows, conf_t, k):
    import functools

    import jax
    return [np.asarray(a) for a in jax.vmap(functools.partial(
        jnms._prepare, conf_threshold=conf_t, k=k))(rows)]


@pytest.mark.parametrize("k", (128, 512, 1024))
@pytest.mark.parametrize("case", CASES)
def test_suppress_matches_jax_backends(jnms, case, k):
    import jax.numpy as jnp
    rows, conf_t, iou_t = _rows(case, 2, k, seed=k)
    boxes, cls, _, valid = _jax_candidates(jnms, jnp.asarray(rows), conf_t, k)
    jb, jc, jv = jnp.asarray(boxes), jnp.asarray(cls), jnp.asarray(valid)
    want = np.asarray(jnms.suppress(jb, jc, jv, iou_t, backend="xla"))
    np.testing.assert_array_equal(
        np.asarray(jnms.suppress(jb, jc, jv, iou_t, backend="xla_loop")), want)
    np.testing.assert_array_equal(
        np.asarray(jnms.suppress(jb, jc, jv, iou_t, backend="pallas",
                                 interpret=True)), want)
    tb, tc, tv = (torch.from_numpy(a) for a in (boxes, cls, valid))
    for backend in ("torch", "torch_loop"):
        got = tnms.suppress(tb, tc, tv, iou_t, backend=backend)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=backend)
    if case == "chain":
        assert want[0].nonzero()[0].tolist() == list(range(0, k, 2))


@pytest.mark.parametrize("case", CASES)
def test_batched_nms_matches_jax(jnms, case):
    """_prepare (stable top-K on ties) + suppress + _compact, exact."""
    import jax.numpy as jnp
    rows, conf_t, iou_t = _rows(case, 3, 300, seed=7)
    j_out, j_valid = jnms.batched_nms(jnp.asarray(rows), iou_t, conf_t,
                                      max_detections=40, pre_nms_topk=256)
    t_out, t_valid = tnms.batched_nms(torch.from_numpy(rows), iou_t, conf_t,
                                      max_detections=40, pre_nms_topk=256)
    np.testing.assert_array_equal(t_valid.numpy(), np.asarray(j_valid))
    np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out))


def test_resolve_backend():
    assert tnms.resolve_backend("auto", "cpu") == "torch"
    assert tnms.resolve_backend("auto", "cuda") == "cuda"
    assert tnms.resolve_backend("torch_loop", "cuda") == "torch_loop"
    with pytest.raises(ValueError):
        tnms.resolve_backend("xla", "cpu")


def test_kernel_wrapper_raises_above_its_cap():
    """K above MAX_K is refused, never quietly handed to the plain version."""
    k = nms_kernel.MAX_K + 1
    boxes = torch.zeros((1, k, 4))
    cls = torch.zeros((1, k))
    valid = torch.ones((1, k), dtype=torch.bool)
    with pytest.raises(ValueError, match="MAX_K"):
        tnms.suppress(boxes, cls, valid, 0.5, backend="cuda")


def _holes(valid, seed):
    """A random valid mask with holes (not a prefix), same shape."""
    return np.random.default_rng(seed).random(valid.shape) < 0.6


def _jax_inputs(jnms, case, bs, k, seed):
    """(boxes, cls, valid) numpy candidates of JAX ``_prepare``; "holes" is
    the dense case with valid replaced by a random non-prefix mask."""
    import jax.numpy as jnp
    rows, conf_t, iou_t = _rows("dense" if case == "holes" else case, bs, k,
                                seed=seed)
    boxes, cls, _, valid = _jax_candidates(jnms, jnp.asarray(rows), conf_t, k)
    if case == "holes":
        valid = _holes(valid, seed)
    return boxes, cls, valid, iou_t


def _jax_keep(jnms, boxes, cls, valid, iou_t):
    import jax.numpy as jnp
    return np.asarray(jnms.suppress(jnp.asarray(boxes), jnp.asarray(cls),
                                    jnp.asarray(valid), iou_t, backend="xla"))


@pytest.mark.parametrize("k", (1, 33, 100, 512))
@pytest.mark.parametrize("case", NEW_CASES)
def test_tiled_plain_matches_jax(jnms, case, k):
    """The kernel's algorithm (diagonal tiles, per-tile resolution, ORs of
    kept rows into later live words) equals JAX suppress exactly."""
    boxes, cls, valid, iou_t = _jax_inputs(jnms, case, 2, k, seed=k)
    want = _jax_keep(jnms, boxes, cls, valid, iou_t)
    got = nms_kernel.greedy_keep_tiled_plain(
        *(torch.from_numpy(a) for a in (boxes, cls, valid)), iou_t)
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "holes":
        assert k == 1 or (valid[:, 1:] & ~valid[:, :-1]).any()  # holes
        assert not (want & ~valid).any()


@pytest.mark.parametrize("case", NEW_CASES)
def test_cuda_backend_on_cpu_runs_plain_versions(jnms, case):
    """On CPU tensors the kernel's wrapper runs its plain version (the
    fixpoint): the keep mask equals JAX suppress exactly, and no kernel
    launch is counted."""
    k = 100                                     # not a multiple of 32
    boxes, cls, valid, iou_t = _jax_inputs(jnms, case, 2, k, seed=3)
    want = _jax_keep(jnms, boxes, cls, valid, iou_t)
    tb, tc, tv = (torch.from_numpy(a) for a in (boxes, cls, valid))
    before = nms_kernel.keep_launches
    got = tnms.suppress(tb, tc, tv, iou_t, backend="cuda")
    direct = nms_kernel.greedy_keep_cuda(tb, tc, tv, iou_t)
    assert nms_kernel.keep_launches == before
    assert got.dtype == torch.bool and got.shape == (2, k)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(direct, got)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the NMS kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k", (1, 33, 128, 512, 1024, 2047, 2048))
@pytest.mark.parametrize("case", NEW_CASES)
def test_cuda_kernel_matches_plain(cuda_device, case, k):
    rows, conf_t, iou_t = _rows("dense" if case == "holes" else case, 8, k,
                                seed=k)
    rows = torch.from_numpy(rows).to(cuda_device)
    boxes, cls, _, valid = tnms._prepare(rows, conf_t, k)
    boxes, cls, valid = boxes.contiguous(), cls.contiguous(), valid.contiguous()
    if case == "holes":
        valid = torch.from_numpy(_holes(valid, k)).to(cuda_device)
    before = nms_kernel.keep_launches
    got = tnms.suppress(boxes, cls, valid, iou_t, backend="cuda")
    torch.cuda.synchronize()
    assert nms_kernel.keep_launches == before + 1
    want = tnms.suppress(boxes, cls, valid, iou_t, backend="torch")
    assert torch.equal(got, want)
