"""The port's weight bridge (yolov5m_tpu_torch/models/weights.py, fuse.py)
against the JAX package's, on the committed flagship blob. Every check is
exact: the same bytes and the same f32/f64 arithmetic on both sides."""

import hashlib
import json

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from yolov5m_tpu.models.fuse import fold_batchnorm as jax_fold
from yolov5m_tpu.models.weights import (FLAGSHIP_WEIGHTS,
                                        export_torch_state_dict)
from yolov5m_tpu_torch.models import weights as tw
from yolov5m_tpu_torch.models.fuse import fold_batchnorm
from yolov5m_tpu_torch.models.yolo import YOLOv5

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def blob():
    with open(FLAGSHIP_WEIGHTS, "rb") as f:
        data = f.read()
    restored = jax.tree.map(lambda x: np.asarray(x, np.float32),
                            serialization.msgpack_restore(data))
    return data, restored


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_msgpack_reader_matches_flax(blob):
    data, restored = blob
    ours = dict(_flat(tw.msgpack_restore(data)))
    theirs = dict(_flat(restored))
    assert ours.keys() == theirs.keys()
    for path, leaf in theirs.items():
        assert ours[path].dtype == np.float32
        np.testing.assert_array_equal(ours[path], leaf, err_msg=str(path))


def test_msgpack_reader_scalar_types():
    """The types flax does not emit in the blob, through flax's packer."""
    doc = {"a": [1, -3, 200, -200, 70000, -70000, 2 ** 40, -(2 ** 40)],
           "b": [1.5, None, True, False, "x" * 40, b"\x00\x01"],
           "c": {"n": np.arange(5, dtype=np.int32)}}
    out = tw.msgpack_restore(serialization.msgpack_serialize(doc))
    assert out["a"] == doc["a"] and out["b"] == doc["b"]
    np.testing.assert_array_equal(out["c"]["n"], doc["c"]["n"])
    with pytest.raises(ValueError, match="trailing"):
        tw.msgpack_restore(serialization.msgpack_serialize(doc) + b"\x00")


def test_flagship_sha256_matches_sidecar(blob):
    data, _ = blob
    with open(FLAGSHIP_WEIGHTS.replace(".msgpack", ".json")) as f:
        sidecar = json.load(f)
    assert hashlib.sha256(data).hexdigest() == sidecar["sha256"]
    variables, side = tw.read_flagship()
    assert side == sidecar


def test_flagship_checksum_mismatch_raises(tmp_path):
    bad = tmp_path / "flagship_synth_bf16.msgpack"
    with open(FLAGSHIP_WEIGHTS, "rb") as f:
        bad.write_bytes(f.read()[:-1] + b"\x00")
    (tmp_path / "flagship_synth_bf16.json").write_text(
        open(FLAGSHIP_WEIGHTS.replace(".msgpack", ".json")).read())
    with pytest.raises(ValueError, match="sha256"):
        tw.read_flagship(str(bad))


def test_state_dict_matches_jax_export(blob):
    _, restored = blob
    want = export_torch_state_dict(restored)
    got = tw.state_dict_from_flax(restored)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == np.float32 and got[k].flags.c_contiguous
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_fold_batchnorm_bit_equal_to_jax(blob):
    """The folded tree (conv biases, no BN) goes through the port's key
    mapping on both sides; the JAX export takes unfolded trees only."""
    _, restored = blob
    sd = {k: torch.from_numpy(v)
          for k, v in tw.state_dict_from_flax(restored).items()}
    got = fold_batchnorm(sd)
    want = tw.state_dict_from_flax(jax_fold(restored))
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("fold", (False, True))
def test_flagship_loads_strict(fold):
    sd, sidecar = tw.load_flagship(fold=fold, device="cpu")
    model = YOLOv5(fused=fold)
    model.load_state_dict(sd, strict=True)
    assert sidecar["sha256"]
    # reference key layout, e.g. a backbone C3 bottleneck and a neck pair
    assert "backbone.2.seq.0.c1.cbl.0.weight" in sd
    assert "neck.1.seq.0.1.cbl.0.weight" in sd
