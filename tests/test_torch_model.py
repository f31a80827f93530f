"""The port's YOLOv5 forward (yolov5m_tpu_torch/models) against the JAX
``YOLOv5.apply`` on the same weights and inputs, f32 on the CPU.

Tolerance: both sides run f32 convolutions whose sums are taken in a
different order (oneDNN vs XLA's CPU convolution), so outputs agree to a
few f32 ulps of the accumulated magnitude, not bit for bit: every output
must lie within 1e-5 of the output's largest magnitude (measured: under
7e-7)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov5m_tpu.models import YOLOv5 as JaxYOLOv5
from yolov5m_tpu.models.fuse import fold_batchnorm as jax_fold
from yolov5m_tpu.models.weights import load_flagship as jax_load_flagship
from yolov5m_tpu_torch.models.weights import load_flagship, state_dict_from_flax
from yolov5m_tpu_torch.models.yolo import YOLOv5, from_family

torch.set_num_threads(1)


def _perturbed_variables(model, hw, seed):
    """model.init, with BN scale/bias/mean/var drawn from numpy so the
    folding and the live BN both do real work."""
    variables = jax.tree.map(np.asarray, jax.jit(model.init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, hw, hw, 3), jnp.float32)))
    rng = np.random.default_rng(seed)

    def draw(path, x):
        name = path[-1].key
        if name == "scale":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name in ("bias", "mean"):
            return rng.normal(0, 0.1, x.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(draw, variables)


def _compare(jax_outs, torch_outs, rtol):
    assert len(jax_outs) == len(torch_outs) == 3
    for j, t in zip(jax_outs, torch_outs):
        j = np.asarray(j)
        assert t.shape == j.shape
        scale = np.abs(j).max()
        np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=rtol * scale)


@pytest.mark.parametrize("fused", (False, True))
def test_small_forward_matches_jax(fused):
    hw = 128
    jmodel = JaxYOLOv5(first_out=16, nc=5, depth_mult=0.33)
    variables = _perturbed_variables(jmodel, hw, seed=3)
    if fused:
        variables = jax_fold(variables)
        jmodel = jmodel.clone(fused=True)
    x = np.random.default_rng(0).uniform(0, 1, (2, hw, hw, 3)).astype(np.float32)
    want = jax.jit(jmodel.apply)(variables, jnp.asarray(x))

    model = YOLOv5(first_out=16, nc=5, depth_mult=0.33, fused=fused).eval()
    sd = {k: torch.from_numpy(v)
          for k, v in state_dict_from_flax(variables).items()}
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    _compare(want, got, 1e-5)


def test_flagship_width_fused_matches_jax():
    """YOLOv5m at full width (first_out 48, nc 80) with the flagship
    weights, BN folded, at 256 px."""
    jvars, _ = jax_load_flagship(fold=True)
    jmodel = JaxYOLOv5(first_out=48, nc=80, fused=True)
    x = np.random.default_rng(1).uniform(0, 1, (1, 256, 256, 3)).astype(
        np.float32)
    want = jax.jit(jmodel.apply)(jvars, jnp.asarray(x))

    sd, _ = load_flagship(fold=True, device="cpu")
    model = YOLOv5(fused=True).eval()
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    _compare(want, got, 1e-5)


def test_family_and_input_checks():
    m = from_family("n", nc=3)
    assert (m.first_out, m.nc) == (16, 3)
    assert len(m.backbone[2].seq) == 1 and len(from_family("m").backbone[6].seq) == 6
    with pytest.raises(ValueError, match="divisible by 32"):
        m(torch.zeros(1, 100, 96, 3))
