"""The port's long-context transformer (models/long_context.py) and dense
attention (parallel/ring_attention.py) against the JAX package's, on the
CPU, on flax-initialised weights carried across by
`convert.long_context_from_flax`.

Tolerances: outputs within atol 2e-6 (the jitted flax forward and the
port's differ in the order of their float32 sums — products, softmax
normalisation, LayerNorm means); the loss within rtol 1e-5; each
parameter's gradient within 1e-6 + 1e-4 of that parameter's largest
gradient (autograd and `jax.grad` accumulate the same terms in other
orders).  On a mesh (the port's 8 CPU shards, JAX's `mesh8`) the ring is
held to the same tolerances against JAX's ring and the port's dense
model, forward, loss and gradient.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ai_crypto_trader_tpu.models import long_context as jlc  # noqa: E402
from ai_crypto_trader_tpu.parallel import ring_attention as jra  # noqa: E402
from ai_crypto_trader_tpu_torch import convert  # noqa: E402
from ai_crypto_trader_tpu_torch.models import (  # noqa: E402
    LongContextTransformer, long_context_loss)
from ai_crypto_trader_tpu_torch.parallel import make_mesh  # noqa: E402
from ai_crypto_trader_tpu_torch.parallel import ring_attention as pra  # noqa: E402

OUT_ATOL = 2e-6
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
D, H, BLOCKS, F = 32, 4, 2, 8


def _case(T, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T, F)).astype(np.float32)
    y = (rng.normal(size=(T, 1)) * 0.01).astype(np.float32)
    y[:7] = np.nan
    y[-1] = np.nan
    model = jlc.LongContextTransformer(d_model=D, num_heads=H, num_blocks=BLOCKS)
    params = model.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    port = convert.long_context_from_flax(params, features=F, d_model=D, num_heads=H,
                                          num_blocks=BLOCKS, device="cpu")
    return model, params, port, x, y


@pytest.mark.parametrize("T,causal", [(64, True), (200, True), (96, False)])
def test_reference_attention_against_jax(T, causal):
    rng = np.random.default_rng(T)
    q, k, v = (rng.normal(size=(T, H, 8)).astype(np.float32) for _ in range(3))
    ref = np.asarray(jax.jit(lambda a, b, c: jra.reference_attention(a, b, c, causal=causal))(
        q, k, v))
    got = pra.reference_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal)
    assert got.dtype == torch.float32 and got.shape == (T, H, 8)
    np.testing.assert_allclose(got.numpy(), ref, atol=OUT_ATOL, rtol=0)
    assert pra.NEG_BIG == jra.NEG_BIG
    # causal: the first query sees only the first key
    if causal:
        np.testing.assert_allclose(got[0].numpy(), v[0], atol=1e-6)


@pytest.mark.parametrize("T", [64, 256])
def test_forward_against_flax(T):
    model, params, port, x, _ = _case(T, seed=T)
    ref = np.asarray(jax.jit(model.apply)(params, jnp.asarray(x))["mean"])
    got = port(torch.from_numpy(x))["mean"]
    assert got.shape == (T, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=OUT_ATOL, rtol=0)
    # causal: a change at the end does not move earlier predictions
    x2 = x.copy()
    x2[-5:] += 1.0
    again = port(torch.from_numpy(x2))["mean"].detach().numpy()
    np.testing.assert_array_equal(again[:-5], got.detach().numpy()[:-5])


@pytest.mark.parametrize("T", [64, 160])
def test_loss_and_gradients_against_jax(T):
    model, params, port, x, y = _case(T, seed=T + 1)
    jloss, jgrad = jax.jit(jax.value_and_grad(
        lambda p: jlc.long_context_loss(model, p, jnp.asarray(x), jnp.asarray(y))))(params)
    named = dict(port.named_parameters())
    loss = long_context_loss(port, named, torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    grads = torch.autograd.grad(loss, list(named.values()))
    ref = convert.state_from_flax(port, jgrad)
    for (name, _), g in zip(named.items(), grads):
        scale = float(ref[name].abs().max())
        np.testing.assert_allclose(g.numpy(), ref[name].numpy(),
                                   atol=GRAD_ATOL + GRAD_RTOL * scale, rtol=0, err_msg=name)
    # the module's own parameters give the same loss; NaN targets are masked
    assert long_context_loss(port, None, torch.from_numpy(x),
                             torch.from_numpy(y)).item() == loss.item()
    assert torch.isfinite(loss)


def test_every_target_nan_gives_zero_loss():
    model, params, port, x, y = _case(32, seed=3)
    y[:] = np.nan
    loss = long_context_loss(port, None, torch.from_numpy(x), torch.from_numpy(y))
    assert loss.item() == float(jlc.long_context_loss(model, params, jnp.asarray(x),
                                                      jnp.asarray(y))) == 0.0


def test_convert_refuses_a_foreign_tree():
    _, params, _, _, _ = _case(32, seed=5)
    with pytest.raises((KeyError, ValueError)):
        convert.long_context_from_flax(params, features=F, d_model=D, num_heads=H,
                                       num_blocks=BLOCKS + 1, device="cpu")


def test_mesh_raises_and_default_device_is_cuda(monkeypatch, mesh8):
    """A mesh that is not the port's raises (JAX's own included); the
    port's builds the ring; the default device is the CUDA card."""
    for foreign in (object(), mesh8):
        with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
            LongContextTransformer(F, mesh=foreign, device="cpu")
    ring = LongContextTransformer(F, d_model=D, mesh=make_mesh(8, devices=["cpu"] * 8),
                                  device="cpu")
    assert ring.LongContextBlock_0.RingSelfAttention_0.mesh is ring.mesh
    assert torch.isfinite(long_context_loss(ring, None, torch.zeros(8, F),
                                            torch.zeros(8, 1)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        LongContextTransformer(F)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.long_context_from_flax({}, features=F)


def _ring_case(T, seed):
    model, params, dense, x, y = _case(T, seed)
    ring = convert.long_context_from_flax(params, features=F, d_model=D, num_heads=H,
                                          num_blocks=BLOCKS,
                                          mesh=make_mesh(8, devices=["cpu"] * 8),
                                          device="cpu")
    return model, params, dense, ring, x, y


def test_ring_forward_on_the_mesh(mesh8):
    """The sequence split over 8 shards: JAX's ring on mesh8 and the port's
    dense model, within OUT_ATOL; causal across the shards."""
    model, params, dense, ring, x, _ = _ring_case(128, seed=21)
    jring = jlc.LongContextTransformer(d_model=D, num_heads=H, num_blocks=BLOCKS, mesh=mesh8)
    ref = np.asarray(jax.jit(jring.apply)(params, jnp.asarray(x))["mean"])
    got = ring(torch.from_numpy(x))["mean"].detach().numpy()
    np.testing.assert_allclose(got, ref, atol=OUT_ATOL, rtol=0)
    np.testing.assert_allclose(got, dense(torch.from_numpy(x))["mean"].detach().numpy(),
                               atol=OUT_ATOL, rtol=0)
    x2 = x.copy()
    x2[64:] = 0.0
    again = ring(torch.from_numpy(x2))["mean"].detach().numpy()
    np.testing.assert_allclose(again[:64], got[:64], atol=OUT_ATOL, rtol=0)


def test_ring_loss_and_gradients_on_the_mesh(mesh8):
    """Gradients flow through the ring's K/V moves: the loss and every
    parameter's gradient against JAX's ring on mesh8 and the port's dense
    model, within LOSS_RTOL and the gradient bound."""
    model, params, dense, ring, x, y = _ring_case(128, seed=22)
    jring = jlc.LongContextTransformer(d_model=D, num_heads=H, num_blocks=BLOCKS, mesh=mesh8)
    jloss, jgrad = jax.jit(jax.value_and_grad(
        lambda p: jlc.long_context_loss(jring, p, jnp.asarray(x), jnp.asarray(y))))(params)
    ref = convert.state_from_flax(ring, jgrad)
    got = {}
    for name, port in (("ring", ring), ("dense", dense)):
        named = dict(port.named_parameters())
        loss = long_context_loss(port, named, torch.from_numpy(x), torch.from_numpy(y))
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
        got[name] = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    for k, g in got["ring"].items():
        scale = float(ref[k].abs().max())
        for want in (ref[k].numpy(), got["dense"][k].numpy()):
            np.testing.assert_allclose(g.numpy(), want, atol=GRAD_ATOL + GRAD_RTOL * scale,
                                       rtol=0, err_msg=k)
