"""The port's space-to-depth stem (yolov5m_tpu_torch/models/s2d.py and
``YOLOv5(stem_s2d=True)``) against the JAX package's, on the CPU.

The three transforms only move values, so they are exactly JAX's (on the
flagship weights too, the slice's full-size check). The s2d model is held
against JAX's s2d model and against the port's own 6x6 model within rtol
1e-4, atol 1e-5 (the bound of tests/test_model.py's s2d test): the 3x3
conv over 12 channels sums the 6x6 conv's products in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov5m_tpu.models import YOLOv5 as JaxYOLOv5
from yolov5m_tpu.models import s2d as js2d
from yolov5m_tpu.models.fuse import fold_batchnorm as jax_fold
from yolov5m_tpu.models.weights import load_flagship as jax_load_flagship
from yolov5m_tpu_torch.models import s2d
from yolov5m_tpu_torch.models.weights import load_flagship, state_dict_from_flax
from yolov5m_tpu_torch.models.yolo import YOLOv5

torch.set_num_threads(1)

HW = 64


def _sd(variables):
    return {k: torch.from_numpy(v)
            for k, v in state_dict_from_flax(variables).items()}


@pytest.fixture(scope="module")
def tiny():
    """(JAX model, its variables with drawn BN statistics) at first_out 8."""
    model = JaxYOLOv5(first_out=8, nc=3)
    variables = jax.tree.map(np.asarray, jax.jit(model.init)(
        jax.random.PRNGKey(2), jnp.zeros((1, HW, HW, 3))))
    rng = np.random.default_rng(2)
    stats = jax.tree.map(
        lambda a: (a + rng.uniform(0.05, 0.3, a.shape)).astype(np.float32),
        variables["batch_stats"])
    return model, {"params": variables["params"], "batch_stats": stats}


@pytest.mark.parametrize("shape", [(2, 64, 64, 3), (1, 32, 96, 5),
                                   (3, 4, 2, 12)])
def test_space_to_depth2_equals_jax(shape):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    want = np.asarray(js2d.space_to_depth2(jnp.asarray(x)))
    got = s2d.space_to_depth2(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("c", [3, 12])
def test_stem_kernel_to_s2d_equals_jax(c):
    w6 = np.random.default_rng(c).normal(size=(6, 6, c, 16)).astype(np.float32)
    want = js2d.stem_kernel_to_s2d(w6)                  # HWIO
    got = s2d.stem_kernel_to_s2d(torch.from_numpy(
        np.transpose(w6, (3, 2, 0, 1)).copy()))        # OIHW
    np.testing.assert_array_equal(got.numpy(), np.transpose(want, (3, 2, 0, 1)))
    with pytest.raises(ValueError, match="6x6"):
        s2d.stem_kernel_to_s2d(torch.zeros(16, 3, 3, 3))


def _assert_sd_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def test_stem_weights_to_s2d_equals_jax(tiny):
    _, variables = tiny
    want = state_dict_from_flax(jax.tree.map(
        np.asarray, js2d.stem_weights_to_s2d(variables)))
    got = s2d.stem_weights_to_s2d(_sd(variables))
    _assert_sd_equal(got, want)
    assert got[s2d.STEM_WEIGHT].shape == (8, 12, 3, 3)


def test_stem_weights_to_s2d_flagship_equals_jax():
    """The full-size check: the flagship weights, BN folded."""
    jvars, _ = jax_load_flagship(fold=True)
    want = state_dict_from_flax(jax.tree.map(
        np.asarray, js2d.stem_weights_to_s2d(jvars)))
    sd, _ = load_flagship(fold=True, device="cpu")
    _assert_sd_equal(s2d.stem_weights_to_s2d(sd), want)


@pytest.mark.parametrize("fused", [False, True], ids=["bn", "fused"])
def test_s2d_model_matches_jax_and_the_6x6_stem(tiny, fused):
    jmodel, variables = tiny
    if fused:
        variables = jax_fold(variables)
        jmodel = jmodel.clone(fused=True)
    jvars_s2d = js2d.stem_weights_to_s2d(variables)
    x = np.random.default_rng(5).uniform(0, 1, (2, HW, HW, 3)).astype(
        np.float32)
    want = jmodel.clone(stem_s2d=True).apply(jvars_s2d, jnp.asarray(x))

    model = YOLOv5(first_out=8, nc=3, fused=fused, stem_s2d=True).eval()
    model.load_state_dict(s2d.stem_weights_to_s2d(_sd(variables)), strict=True)
    plain = YOLOv5(first_out=8, nc=3, fused=fused).eval()
    plain.load_state_dict(_sd(variables), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
        six = plain(torch.from_numpy(x))
    assert model.backbone[0].cbl[0].weight.shape == (8, 12, 3, 3)
    for g, w, p in zip(got, want, six):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(g.numpy(), p.numpy(), rtol=1e-4, atol=1e-5)


def test_s2d_input_is_cast_first():
    """bf16: the input is cast to the compute dtype before s2d, so the
    stem sees the same bf16 values as the 6x6 model (JAX's order)."""
    torch.manual_seed(0)
    model = YOLOv5(first_out=8, nc=3, fused=True, stem_s2d=True,
                   compute_dtype=torch.bfloat16).eval()
    seen = []
    model.backbone[0].register_forward_hook(
        lambda m, args, out: seen.append(args[0]))
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 1, (1, HW, HW, 3)).astype(np.float32))
    with torch.no_grad():
        model(x)
    want = s2d.space_to_depth2(x.to(torch.bfloat16)).permute(0, 3, 1, 2)
    assert seen[0].dtype == torch.bfloat16
    assert torch.equal(seen[0], want)
