"""The port's own flax-msgpack reader and the MattingUNet weight map,
against `flax.serialization.msgpack_restore`."""
import jax
import numpy as np
import pytest
from flax import serialization

from tests.torch_jax_cache import cache_every_compile  # noqa: F401
from tests.torch_port_util import assert_equal
from video_unscreen_tpu_torch.models.matting_unet import MattingUNet
from video_unscreen_tpu_torch.utils.checkpoint import (load_matting_unet,
                                                       read_msgpack)

WEIGHTS = "weights/matting_unet.msgpack"


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def restored():
    with open(WEIGHTS, "rb") as f:
        want = serialization.msgpack_restore(f.read())
    return want, read_msgpack(WEIGHTS)


def test_reader_matches_flax_on_the_checkpoint(restored):
    want, got = restored
    fw, fg = _flat(want), _flat(got)
    assert sorted(fw) == sorted(fg)
    for k in fw:
        assert fg[k].dtype == fw[k].dtype, k
        assert_equal(fg[k], fw[k], k)


def test_reader_matches_flax_on_every_type(tmp_path):
    rng = np.random.RandomState(0)
    tree = {
        "ints": {"small": 7, "neg": -3, "neg8": -100, "u16": 40000,
                 "i32": -70000, "u64": 2 ** 40, "i64": -(2 ** 40)},
        "floats": {"f": 0.25, "g": -1e300},
        "flags": {"t": True, "f": False, "none": None},
        "text": {"short": "ab", "long": "x" * 300},
        "arrays": {"f32": rng.randn(3, 4).astype(np.float32),
                   "i32": rng.randint(-9, 9, (5,)).astype(np.int32),
                   "u8": rng.randint(0, 255, (2, 2, 2)).astype(np.uint8),
                   "f64": rng.randn(7).astype(np.float64),
                   "b": rng.rand(4) > 0.5,
                   "empty": np.zeros((0, 3), np.float32)},
        "scalar": np.float32(1.5),
        "list": [1, 2, 3],
        "big": {str(i): i for i in range(40)},
    }
    path = tmp_path / "tree.msgpack"
    path.write_bytes(serialization.msgpack_serialize(tree))
    got = read_msgpack(path)
    want = serialization.msgpack_restore(path.read_bytes())
    fw, fg = _flat(want), _flat(got)
    assert sorted(fw) == sorted(fg)
    for k in fw:
        assert type(np.asarray(fg[k]).dtype) is type(np.asarray(fw[k]).dtype)
        assert_equal(np.asarray(fg[k]), np.asarray(fw[k]), k)


def test_state_dict_covers_the_module_exactly(restored):
    _, tree = restored
    state = load_matting_unet(tree)
    ref = MattingUNet().state_dict()
    assert sorted(state) == sorted(ref)
    for k, v in ref.items():
        assert tuple(state[k].shape) == tuple(v.shape), k
    # the path form gives the same tensors
    from_path = load_matting_unet(WEIGHTS)
    for k in state:
        assert_equal(from_path[k], state[k], k)
