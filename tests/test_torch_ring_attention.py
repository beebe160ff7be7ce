"""Ring attention: the port's ring against the dense oracles, on the CPU.

tests/test_ring_attention.py's cases and tolerances (f32, 2e-5): the
sequence split 8 ways over a virtual mesh of CPU shards must reproduce full
softmax attention — JAX's `reference_attention`, JAX's ring on its `mesh8`
and the port's dense `reference_attention` — including rows whose keys
come from other shards; and the ring's gradient must be the dense one.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ai_crypto_trader_tpu.parallel import ring_attention as jra  # noqa: E402
from ai_crypto_trader_tpu_torch.parallel import make_mesh  # noqa: E402
from ai_crypto_trader_tpu_torch.parallel.ring_attention import (  # noqa: E402
    reference_attention, ring_self_attention)

T, H, D = 256, 4, 16
TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def tmesh8():
    return make_mesh(8, devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def qkv():
    rng = np.random.default_rng(3)
    return tuple(rng.normal(0, 1, (T, H, D)).astype(np.float32) for _ in range(3))


def _t(qkv):
    return tuple(torch.tensor(x) for x in qkv)


class TestRingMatchesDense:
    @pytest.mark.parametrize("causal", [True, False])
    def test_parity(self, tmesh8, mesh8, qkv, causal):
        got = ring_self_attention(*_t(qkv), tmesh8, causal=causal).numpy()
        jq = tuple(jnp.asarray(x) for x in qkv)
        np.testing.assert_allclose(got, np.asarray(jra.reference_attention(*jq, causal=causal)),
                                   **TOL)
        np.testing.assert_allclose(got, np.asarray(jra.ring_self_attention(*jq, mesh8,
                                                                           causal=causal)), **TOL)
        np.testing.assert_allclose(got, reference_attention(*_t(qkv), causal=causal).numpy(),
                                   **TOL)

    def test_cross_device_rows_match(self, tmesh8, qkv):
        """Rows whose causal window spans several shards' K/V blocks are
        where a broken rotation would show."""
        want = np.asarray(jra.reference_attention(*(jnp.asarray(x) for x in qkv), causal=True))
        got = ring_self_attention(*_t(qkv), tmesh8, causal=True).numpy()
        blk = T // 8
        for row in (blk, 3 * blk + 1, T - 1):
            np.testing.assert_allclose(got[row], want[row], **TOL)

    def test_output_is_gathered_in_the_input_dtype(self, tmesh8, qkv):
        out = ring_self_attention(*_t(qkv), tmesh8)
        assert out.shape == (T, H, D) and out.dtype == torch.float32

    def test_single_device_degenerates(self, qkv):
        mesh1 = make_mesh(1, devices=["cpu"])
        got = ring_self_attention(*_t(qkv), mesh1, causal=True).numpy()
        np.testing.assert_allclose(got, reference_attention(*_t(qkv)).numpy(), **TOL)

    def test_indivisible_length_raises(self, tmesh8):
        q = torch.zeros((250, H, D))
        with pytest.raises(ValueError, match="divisible"):
            ring_self_attention(q, q, q, tmesh8)


class TestCausality:
    def test_future_keys_have_no_influence(self, tmesh8, qkv):
        """Perturbing the last K/V block must leave every earlier causal
        output untouched — across shard boundaries."""
        q, k, v = _t(qkv)
        base = ring_self_attention(q, k, v, tmesh8, causal=True).numpy()
        blk = T // 8
        k2, v2 = k.clone(), v.clone()
        v2[-blk:] += 100.0
        k2[-blk:] += 1.0
        pert = ring_self_attention(q, k2, v2, tmesh8, causal=True).numpy()
        np.testing.assert_allclose(pert[: T - blk], base[: T - blk], **TOL)
        assert not np.allclose(pert[T - blk:], base[T - blk:])

    def test_first_row_attends_only_itself(self, tmesh8, qkv):
        got = ring_self_attention(*_t(qkv), tmesh8, causal=True).numpy()
        np.testing.assert_allclose(got[0], qkv[2][0], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_gradient_through_the_ring_is_the_dense_one(tmesh8, qkv, causal):
    """Autograd follows the K/V moves: d(Σ w·out)/d(q, k, v) through the
    ring equals the dense attention's."""
    w = torch.tensor(np.random.default_rng(9).normal(size=(T, H, D)).astype(np.float32))

    def grads(fn):
        q, k, v = (x.clone().requires_grad_() for x in _t(qkv))
        return torch.autograd.grad((fn(q, k, v) * w).sum(), (q, k, v))

    ring = grads(lambda q, k, v: ring_self_attention(q, k, v, tmesh8, causal=causal))
    dense = grads(lambda q, k, v: reference_attention(q, k, v, causal=causal))
    for name, g, r in zip("qkv", ring, dense):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-4, atol=1e-4, err_msg=name)
