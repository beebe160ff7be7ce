"""The port's meshes, shardings, padding and partition rules, on the CPU.

The JAX package's cases (tests/test_parallel.py, tests/test_partitioner.py
`TestPartitionRules`) on a virtual mesh of 8 CPU shards, the JAX side on
its `mesh8` of 8 virtual CPU devices; `initialize_distributed` with gloo at
world size 1 in a subprocess.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
from jax.sharding import PartitionSpec as JP  # noqa: E402

from ai_crypto_trader_tpu.parallel import match_partition_rules as jax_rules  # noqa: E402
from ai_crypto_trader_tpu_torch.parallel import (  # noqa: E402
    data_sharding, default_mesh, initialize_distributed, make_mesh, match_partition_rules,
    pad_to_multiple, replicated, shard_leading_axis)
from ai_crypto_trader_tpu_torch.parallel import mesh as tmesh  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(scope="module")
def tmesh8():
    return make_mesh(data_parallel=8, model_parallel=1, devices=CPU8)


class TestMesh:
    def test_shapes(self, tmesh8, mesh8):
        assert tmesh8.shape == {"data": 8, "model": 1} == dict(mesh8.shape)
        assert tmesh8.axis_names == tuple(mesh8.axis_names)
        assert tmesh8.devices.shape == mesh8.devices.shape
        assert tmesh8.axis_devices() == CPU8

    def test_two_axis(self):
        from ai_crypto_trader_tpu.parallel import make_mesh as jmake

        mesh = make_mesh(data_parallel=4, model_parallel=2, devices=CPU8)
        assert mesh.shape == {"data": 4, "model": 2} == dict(jmake(4, 2).shape)
        assert len(mesh.axis_devices("model")) == 2 and len(mesh.axis_devices("data")) == 4

    def test_auto_data_parallel(self):
        assert make_mesh(model_parallel=2, devices=CPU8).shape["data"] == 4   # 8 / 2

    def test_oversubscription_raises(self):
        with pytest.raises(ValueError):
            make_mesh(data_parallel=16, devices=CPU8)
        with pytest.raises(ValueError):
            make_mesh(model_parallel=16, devices=CPU8)

    @pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA card makes the mesh")
    def test_without_cuda_the_devices_must_be_given(self):
        with pytest.raises(RuntimeError, match="devices="):
            make_mesh()
        default_mesh.cache_clear()
        with pytest.raises(RuntimeError):
            default_mesh()

    def test_equal_meshes_hash_alike(self, tmesh8):
        other = make_mesh(8, devices=["cpu"] * 8)
        assert other == tmesh8 and hash(other) == hash(tmesh8)
        assert make_mesh(4, devices=CPU8) != tmesh8


class TestSharding:
    def test_data_sharding_places_shards(self, tmesh8, mesh8):
        from ai_crypto_trader_tpu.parallel import data_sharding as jds

        sh = data_sharding(tmesh8, ndim=2)
        assert sh.spec == tuple(jds(mesh8, ndim=2).spec) == ("data", None)
        x = torch.arange(16.0).reshape(16, 1)
        shards = shard_leading_axis(tmesh8, x)
        assert len(shards) == 8 and all(s.shape == (2, 1) for s in shards)
        assert torch.equal(shards.gather(), x)

    def test_replicated(self, tmesh8):
        assert replicated(tmesh8).is_fully_replicated and replicated(tmesh8).spec == ()

    def test_shard_leading_axis_tree(self, tmesh8):
        out = shard_leading_axis(tmesh8, {"a": torch.ones((8, 3)), "b": torch.zeros((16,))})
        assert len(out["a"]) == 8 and len(out["b"]) == 8
        assert [s.device for s in out["b"]] == CPU8


class TestPadding:
    @pytest.mark.parametrize("as_tensor", [False, True])
    def test_pad_and_orig_size(self, as_tensor):
        x = torch.ones((10, 3)) if as_tensor else np.ones((10, 3))
        y, orig = pad_to_multiple(x, 8)
        assert tuple(y.shape) == (16, 3) and orig == 10
        np.testing.assert_allclose(np.asarray(y)[10:], 0.0)

    def test_already_aligned_untouched(self):
        x = np.ones((16, 2))
        y, orig = pad_to_multiple(x, 8)
        assert y is x and orig == 16

    @pytest.mark.parametrize("as_tensor", [False, True])
    def test_pad_other_axis(self, as_tensor):
        x = torch.ones((3, 10)) if as_tensor else np.ones((3, 10))
        y, orig = pad_to_multiple(x, 4, axis=1, pad_value=-1.0)
        assert tuple(y.shape) == (3, 12) and orig == 10
        np.testing.assert_allclose(np.asarray(y)[:, 10:], -1.0)


class TestPartitionRules:
    def test_regex_rules_and_scalar_passthrough_as_jax(self):
        tree = {"dense": {"kernel": np.ones((4, 8)), "bias": np.ones((8,))},
                "scale": np.float32(2.0)}
        specs = match_partition_rules([(r"kernel", (None, "model")), (r".*", ())], tree)
        ref = jax_rules([(r"kernel", JP(None, "model")), (r".*", JP())], tree)
        assert specs["dense"]["kernel"] == (None, "model") == tuple(ref["dense"]["kernel"])
        assert specs["dense"]["bias"] == () == tuple(ref["dense"]["bias"])
        assert specs["scale"] == () == tuple(ref["scale"])      # scalars never partitioned

    def test_one_element_leaf_and_list_paths(self):
        tree = {"w": [torch.ones((2, 2)), torch.ones((1,))]}
        specs = match_partition_rules([(r"w/0", ("data", None))], tree)
        assert specs == {"w": [("data", None), ()]}

    def test_uncovered_leaf_raises(self):
        with pytest.raises(ValueError, match="no partition rule"):
            match_partition_rules([(r"kernel", ())], {"other": np.ones((3, 3))})
        with pytest.raises(ValueError, match="no partition rule"):
            jax_rules([(r"kernel", JP())], {"other": np.ones((3, 3))})


def test_shard_loop_copies_replicated_arguments_once_per_distinct_device(tmesh8):
    seen = []
    scale = torch.tensor(2.0)

    def fn(block, s):
        seen.append((tmesh.current_shard().index, s is scale))
        return block * s

    shards = tmesh.split_leading(torch.arange(8.0), tmesh8.axis_devices())
    out = tmesh.shard_loop(fn, tmesh8, [shards], (scale,))
    assert [i for i, _ in seen] == list(range(8))
    assert all(same for _, same in seen)          # one device: nothing copied
    assert torch.equal(tmesh.gather_shards(out), torch.arange(8.0) * 2.0)


_DIST = r"""
import socket, torch, torch.distributed as dist
from ai_crypto_trader_tpu_torch.parallel import initialize_distributed
s = socket.socket(); s.bind(("127.0.0.1", 0)); port = s.getsockname()[1]; s.close()
backend = initialize_distributed(f"127.0.0.1:{port}", 1, 0, device="cpu")
x = torch.ones(3)
dist.all_reduce(x)
print(backend, dist.get_world_size(), dist.get_rank(), x.tolist())
dist.destroy_process_group()
"""


def test_initialize_distributed_gloo_world_of_one():
    """A tcp:// coordinator, world size 1, rank 0, gloo for the CPU: an
    all_reduce over the group of one returns its input."""
    env = {k: v for k, v in os.environ.items() if not k.startswith(("MASTER_", "WORLD_",
                                                                      "RANK"))}
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", _DIST], capture_output=True, text=True,
                         timeout=120, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["gloo", "1", "0", "[1.0,", "1.0,", "1.0]"]


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA card takes NCCL")
def test_initialize_distributed_defaults_to_the_card():
    with pytest.raises(RuntimeError, match="CUDA"):
        initialize_distributed("127.0.0.1:1", 1, 0)
