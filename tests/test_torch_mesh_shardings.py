"""The port's `param_shardings` and `spatial_sharding` against the JAX
package's, and what a (data 2, model 2) mesh of 4 `gloo` CPU ranks holds.

Mirrors `tests/test_parallel.py:14-33`: JAX's rule and the port's on the
same trees at (2, 2) and (1, 1) (`make_mesh(4)` and `make_mesh(1)` on the
suite's 8 virtual CPU devices; the port's `Mesh` of that shape, which the
rule reads without a process group), the test's tree plus a transposed
conv's (4, 4, Cin, Cout) kernel and depthwise (3, 3, 1, C) kernels, and
the flax variables of every family's model. On 4 spawned ranks
(`tests/torch_train_rank_cases.py:sharding_cases`): `spatial_sharding`'s
block on each rank is the shard JAX's `device_put` places on the device
at the same mesh position, and its gather is the whole; after one step of
the MattingUNet (its transposed convs split on torch dim 1) and of the
ISeg (its depthwise convs), each rank holds half of every split leaf,
its gradient and both moments; a split leaf the loss does not reach has
an exact zero block on every rank.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.nn as nn

from tests import torch_train_rank_cases as cases
from tests.torch_jax_cache import cache_every_compile  # noqa: F401
from video_unscreen_tpu.parallel import make_mesh as jax_make_mesh
from video_unscreen_tpu.parallel.mesh import param_shardings as jax_shardings
from video_unscreen_tpu.parallel.mesh import \
    spatial_sharding as jax_spatial_sharding
from video_unscreen_tpu_torch.parallel.launch import run_ranks
from video_unscreen_tpu_torch.parallel.mesh import (Mesh, param_shardings,
                                                    shard_axis)
from video_unscreen_tpu_torch.utils.checkpoint import variables_tree

TREE = {
    "big_conv": {"kernel": np.zeros((3, 3, 64, 128), np.float32)},
    "small_conv": {"kernel": np.zeros((3, 3, 3, 8), np.float32)},
    "scale": np.zeros((128,), np.float32),
    "odd_scale": np.zeros((65,), np.float32),
    "small_scale": np.zeros((32,), np.float32),
    "up": {"kernel": np.zeros((4, 4, 256, 256), np.float32)},
    "depthwise": {"kernel": np.zeros((3, 3, 1, 160), np.float32)},
    "small_depthwise": {"kernel": np.zeros((3, 3, 1, 32), np.float32)},
    "head": {"kernel": np.zeros((1, 1, 256, 2), np.float32),
             "bias": np.zeros((2,), np.float32)},
}


def _port_mesh(n):
    shape = {1: (1, 1), 4: (2, 2)}[n]
    return Mesh(shape, ("data", "model"), 0, {"data": None, "model": None})


def _pairs(got, want, prefix=()):
    assert got.keys() == want.keys(), prefix
    for k in want:
        if isinstance(want[k], dict):
            yield from _pairs(got[k], want[k], prefix + (k,))
        else:
            yield prefix + (k,), got[k], want[k]


def _spec_leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _spec_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("n", [4, 1])
def test_param_shardings_match_jax(n):
    want = jax_shardings(TREE, jax_make_mesh(n))
    got = param_shardings(TREE, _port_mesh(n))
    split = []
    for path, g, w in _pairs(got, want):
        assert g == tuple(w.spec), (path, g, w.spec)
        split += [path] if g else []
    if n == 4:
        assert got["big_conv"]["kernel"] == (None, None, None, "model")
        assert got["small_conv"]["kernel"] == ()
        assert got["up"]["kernel"] == (None, None, None, "model")
        assert got["depthwise"]["kernel"] == (None, None, None, "model")
        assert got["scale"] == ("model",)
        assert len(split) == 4
    else:
        assert split == []


@pytest.mark.parametrize("name", cases.FAMILIES)
@pytest.mark.parametrize("n", [4, 1])
def test_param_shardings_of_models_match_jax(name, n):
    """The rule on a model (read from its shapes) is JAX's rule on the
    model's flax params; at (2, 2) it splits some leaves and never a
    classifier of 2 or 20 outputs."""
    model = cases.reduced(name)
    params = variables_tree(model)["params"]
    want = jax_shardings(params, jax_make_mesh(n))
    got = param_shardings(model, _port_mesh(n))
    n_split = 0
    for path, g, w in _pairs(got, want):
        assert g == tuple(w.spec), (path, g, w.spec)
        n_split += bool(g)
    assert (n_split > 0) == (n == 4)


def test_shard_axis_rule():
    assert shard_axis((3, 3, 64, 128), 2) == 3
    assert shard_axis((128,), 2) == 0
    assert shard_axis((3, 3, 64, 63), 1) is None
    assert shard_axis((3, 3, 64, 62), 2) is None   # below 64
    assert shard_axis((66,), 4) is None            # not divisible
    assert shard_axis((3, 64, 128), 2) is None     # neither 1-D nor 4-D


@pytest.fixture(scope="module")
def spatial():
    return np.random.RandomState(3).rand(4, 6, 8, 5).astype(np.float32)


@pytest.fixture(scope="module")
def ranks(spatial):
    return run_ranks(cases.sharding_cases, 4, (spatial,), timeout=240)


def test_spatial_sharding_matches_jax(ranks, spatial):
    mesh = jax_make_mesh(4)
    placed = jax.device_put(jnp.asarray(spatial),
                            jax_spatial_sharding(mesh))
    shards = {s.device: np.asarray(s.data) for s in placed.addressable_shards}
    for rank, r in enumerate(ranks):
        d, m = r["coords"]["data"], r["coords"]["model"]
        assert (d, m) == (rank // 2, rank % 2)
        want = shards[mesh.devices[d, m]]
        assert want.shape == (2, 6, 4, 5)
        np.testing.assert_array_equal(r["block"], want)
        np.testing.assert_array_equal(r["gathered"], spatial)


@pytest.mark.parametrize("name", ["matting", "iseg"])
def test_each_rank_holds_half_of_each_split_leaf(ranks, name):
    model = cases.reduced(name)
    split = [p for p, s in _spec_leaves(param_shardings(model,
                                                        _port_mesh(4))) if s]
    kinds = set()
    for r in ranks:
        n_split = 0
        for pname, shapes in r[name].items():
            p = model.get_parameter(pname)
            mod = model.get_submodule(pname.rsplit(".", 1)[0])
            assert len(set(shapes)) == 1, (pname, shapes)
            if shapes[0] == tuple(p.shape):
                continue
            dim = int(isinstance(mod, nn.ConvTranspose2d) and p.ndim == 4)
            want = list(p.shape)
            want[dim] //= 2
            assert shapes[0] == tuple(want), (pname, shapes[0])
            n_split += 1
            kinds.add("transposed" if dim else "depthwise"
                      if getattr(mod, "groups", 1) > 1 else "conv"
                      if p.ndim == 4 else "1-D")
        assert n_split == len(split)
    assert kinds >= ({"transposed", "conv", "1-D"} if name == "matting"
                     else {"depthwise", "conv", "1-D"}), kinds


def test_unreached_split_leaf_is_an_exact_zero_block(ranks):
    for r in ranks:
        assert r["unused_block"].shape == (32, 64, 1, 1)
        assert not r["unused_block"].any()
        assert r["unused_whole"].shape == (64, 64, 1, 1)
        assert not r["unused_whole"].any()
