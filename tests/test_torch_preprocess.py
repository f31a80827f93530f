"""The port's preprocessing (yolov5m_tpu_torch/ops/preprocess.py and the host
side in data/native.py) against the JAX package's."""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from yolov5m_tpu.data import native as jax_native
from yolov5m_tpu.models import YOLOv5 as JaxYOLOv5
from yolov5m_tpu.models.fuse import fold_batchnorm as jax_fold
from yolov5m_tpu.models.yolo import normalized_anchors
from yolov5m_tpu.ops import preprocess as jpre
from yolov5m_tpu_torch.data import native
from yolov5m_tpu_torch.models.weights import state_dict_from_flax
from yolov5m_tpu_torch.models.yolo import YOLOv5
from yolov5m_tpu_torch.ops import preprocess as tpre

torch.set_num_threads(1)


@pytest.mark.parametrize("dtype", ("bfloat16", "float32"))
def test_normalize_uint8_all_codes_exact(dtype):
    codes = np.arange(256, dtype=np.uint8)
    want = np.asarray(jpre.normalize_uint8(jnp.asarray(codes),
                                           getattr(jnp, dtype)))
    got = tpre.normalize_uint8(torch.from_numpy(codes), getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(),
                                  want.astype(np.float32))


@pytest.mark.parametrize("src_hw", ((48, 80), (100, 52), (64, 64), (30, 70)))
def test_letterbox_geometry_matches_jax(src_hw):
    assert tpre.letterbox_geometry(src_hw, (64, 64)) == \
        jpre.letterbox_geometry(src_hw, (64, 64))


@pytest.mark.parametrize("src_hw", ((48, 80), (100, 52), (64, 64)))
def test_letterbox_normalize_matches_jax(src_hw):
    """Resize (where the aspect needs it), round, pad: the same f32
    operations on the same static index tables, so the pixel codes are
    exact. The final /255 is within 1 f32 ulp: XLA's jit rewrites the
    divide by a constant as a multiply by its reciprocal; the port keeps
    the true divide, as normalize_uint8 does on both sides."""
    x = np.random.default_rng(0).integers(0, 256, (2, *src_hw, 3), np.uint8)
    want = np.asarray(jpre.letterbox_normalize(jnp.asarray(x), (64, 64)))
    got = tpre.letterbox_normalize(torch.from_numpy(x), (64, 64)).numpy()
    np.testing.assert_array_equal(np.round(got * 255), np.round(want * 255))
    np.testing.assert_array_max_ulp(got, want, maxulp=1)


def test_make_serving_fn_matches_jax():
    """uint8 frames -> detections in source coordinates, through a small
    f32 model with the same weights on both sides. Rows and validity
    exact up to sigmoid ulps (1e-6 relative, 1e-4 px)."""
    src_hw, s = (48, 80), 64
    jmodel = JaxYOLOv5(first_out=8, nc=4, depth_mult=0.33)
    variables = jax_fold(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, s, s, 3), jnp.float32)))
    jmodel = jmodel.clone(fused=True)
    kw = dict(image_size=s, conf=0.01, iou=0.45, max_detections=16,
              pre_nms_topk=32)
    x = np.random.default_rng(1).integers(0, 256, (2, *src_hw, 3), np.uint8)
    j_det, j_valid = jpre.make_serving_fn(
        jmodel, variables, jnp.asarray(normalized_anchors()), src_hw,
        **kw)(jnp.asarray(x))

    model = YOLOv5(first_out=8, nc=4, depth_mult=0.33, fused=True).eval()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           state_dict_from_flax(variables).items()})
    t_det, t_valid = tpre.make_serving_fn(model, normalized_anchors(),
                                          src_hw, **kw)(torch.from_numpy(x))
    np.testing.assert_array_equal(t_valid.numpy(), np.asarray(j_valid))
    assert int(t_valid.sum()) > 0
    np.testing.assert_allclose(t_det.numpy(), np.asarray(j_det), rtol=1e-6,
                               atol=1e-4)


@pytest.mark.parametrize("src_hw", ((480, 640), (640, 640), (64, 30)))
def test_host_letterbox_exact_without_resize(src_hw):
    """Only padding: byte-equal to the JAX package's native letterbox."""
    img = np.random.default_rng(2).integers(0, 256, (*src_hw, 3), np.uint8)
    dst = (640, 640) if src_hw[1] == 640 else (64, 30)
    got, ratio, dwdh = native.letterbox(img, dst)
    want, j_ratio, j_dwdh = jax_native.letterbox(img, dst)
    assert (ratio, dwdh) == (j_ratio, j_dwdh)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("src_hw", ((48, 80), (100, 52), (333, 517)))
def test_host_letterbox_within_one_code_with_resize(src_hw):
    """With a resize: the port's C library is the JAX package's code built
    with the same flags, so its letterbox is byte-equal. The numpy plain
    version may round the other way at a .5 boundary where the C build
    contracts a lerp into an FMA: at most 1 code per pixel."""
    img = np.random.default_rng(3).integers(0, 256, (*src_hw, 3), np.uint8)
    got, ratio, dwdh = native.letterbox(img, (64, 64))
    want, j_ratio, j_dwdh = jax_native.letterbox(img, (64, 64))
    assert (ratio, dwdh) == (j_ratio, j_dwdh)
    np.testing.assert_array_equal(got, want)
    plain, _, _ = native.letterbox_plain(img, (64, 64))
    diff = np.abs(plain.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1


def test_decode_image_ppm_png_and_garbage():
    img = np.random.default_rng(4).integers(0, 256, (30, 70, 3), np.uint8)
    ppm = native.encode_ppm(img)
    np.testing.assert_array_equal(native.decode_image(ppm), img)
    # PIL reads the same bytes to the same pixels
    with Image.open(io.BytesIO(ppm)) as im:
        np.testing.assert_array_equal(np.asarray(im.convert("RGB")), img)
    commented = b"P6\n# a comment\n70 30\n255\n" + img.tobytes()
    np.testing.assert_array_equal(native.decode_image(commented), img)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "PNG")
    np.testing.assert_array_equal(native.decode_image(buf.getvalue()), img)
    assert native.decode_image(b"definitely not an image") is None
    assert native.decode_ppm(ppm[:-1]) is None       # truncated pixels
