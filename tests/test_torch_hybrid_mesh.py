"""The port's hybrid process mesh on the CPU: ranks that each drive several
local shards.

A module fixture starts one gloo group of 2 ranks on the CPU, each rank a
subprocess that runs this file as a script: it brings the group up,
builds the hybrid mesh with `process_mesh(local_devices=["cpu"] * 2)` —
G = 4 global shards, local shard j of rank r global shard 2r + j — and
runs every seam of tests/test_torch_process_mesh.py (the sweep, the GA,
the tenant engine, `lob_sweep`, the PBT generation, the structure pool,
the HPO farm, `time_shard`, the ring) through a `MeshPartitioner` of it
on the inputs the test saved, then writes its outputs with
``torch.save``.  The default meshes (`make_mesh()`, `get_partitioner()`,
`cli mesh`) then run on the group's record as a host that gives each rank
two devices would write it (the CPU twice), rank 1 with every exchange
made to raise: the default mesh is built with no collective.  Populations of
10 pad to 12; the ring runs at T = 72, which splits over 4.

Every rank's outputs must be identical and equal the port's single device
and its 4-shard one-controller mesh bit for bit (`time_shard`: the
one-controller mesh; the ring within its tolerances), and match the JAX
package's single-device run at the tolerance
tests/test_torch_mesh_partitioner.py:1-20 gives each seam, on the recorded
JAX draws (`_Replay`).  The checks are tests/test_torch_process_mesh.py's,
at world G.  Beside them: each shard's global rows in `current_shard()`,
the HPO farm's trial-to-(rank, local device) assignment, the ring's
backward with the loss on rank 0's first block alone (causal masking
skips every other block there), and ranks with unequal local shard counts
refused.
"""

import contextlib
import io
import os
import sys
import tempfile

import pytest
import torch

import test_torch_process_mesh as pm
from test_torch_process_mesh import _ranks, _same_bits

WORLD, LOCAL = 2, 2
G = WORLD * LOCAL


# -- the extra seams, run by a rank -------------------------------------------------------

def _shard_rows(part):
    """Each local shard's `current_shard()` in a population of 10 (padded
    to 12), and the program's output."""
    from ai_crypto_trader_tpu_torch.parallel.mesh import current_shard

    seen = []

    def fn(t):
        s = current_shard()
        seen.append((s.index, s.count, str(s.device), s.lo, s.hi, s.population))
        return t * 2.0

    return {"shards": seen, "out": part.population_eval(fn)(torch.arange(10.0))}


def _ring_first_block(part, inp):
    """The ring with the loss on the output's first block alone: rank 0's
    local shard 0, where causal masking skips every block but its own."""
    from ai_crypto_trader_tpu_torch.parallel.ring_attention import ring_self_attention

    q, k, v = (t.clone().requires_grad_(True) for t in inp["qkv"])
    out = ring_self_attention(q, k, v, part.mesh, causal=True)
    tb = pm.T_RING // G
    grads = torch.autograd.grad((out[:tb] * inp["weight"][:tb]).sum(), [q, k, v])
    return {"out": out.detach(), "grads": [g.detach() for g in grads]}


# -- one rank -------------------------------------------------------------------------

@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _rank_main(rank: int, port: int, workdir: str) -> None:
    """One rank: the group up over gloo on the CPU, the hybrid mesh of
    LOCAL CPU shards a rank, every seam, the CLI's layout and the refusal
    of unequal local shard counts written to ``workdir/rank{rank}.pt``."""
    torch.set_num_threads(1)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch.distributed as dist

    from ai_crypto_trader_tpu_torch import cli
    from ai_crypto_trader_tpu_torch.parallel import (
        MeshPartitioner, get_partitioner, initialize_distributed)
    from ai_crypto_trader_tpu_torch.parallel import mesh as tmesh
    from ai_crypto_trader_tpu_torch.utils import meshprof

    initialize_distributed(f"127.0.0.1:{port}", WORLD, rank, device="cpu")
    part = MeshPartitioner(tmesh.process_mesh(local_devices=["cpu"] * LOCAL))
    mesh = part.mesh
    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    res = {"own_shards": [(g, str(d)) for g, d in mesh.own_shards()]}
    for name, fn in pm.SEAMS.items():
        res[name] = fn(part, inp)
    res["hpo_farmed"] = res["hpo"].pop("farmed_here")        # this rank's trials alone
    res["rows"] = _shard_rows(part)
    res["ring_first_block"] = _ring_first_block(part, inp)
    mp = meshprof.MeshProf()
    with meshprof.use(mp):
        part.population_eval(lambda t: {"sq": t * t}, name="toy")(torch.ones(10, 4))
    res["layout"] = mp.layouts["toy"].to_dict()
    # the default meshes: the record a host giving each rank LOCAL devices writes
    tmesh._PROCESS = tmesh._PROCESS._replace(rank_devices=(("cpu",) * LOCAL,) * WORLD)
    tmesh.default_mesh.cache_clear()
    with contextlib.ExitStack() as stack:
        if rank == 1:                        # rank 1 alone, and with no exchange
            def no_collective(*args, **kwargs):
                raise AssertionError("the default mesh ran a collective")
            for mod in (dist, tmesh):
                stack.enter_context(_patched(mod, "all_gather_object", no_collective))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(["mesh", "--pop", "10"])
        res.update(cli=buf.getvalue(), make_mesh=tmesh.make_mesh().shape,
                   describe=get_partitioner().describe(),
                   default_is_hybrid=tmesh.default_mesh() == mesh)
    try:                                           # rank r drives 1 + r shards
        tmesh.process_mesh(local_devices=["cpu"] * (1 + rank))
        res["unequal"] = None
    except ValueError as e:
        res["unequal"] = str(e)
    res["transport"] = tmesh.TRANSPORT.counts()
    torch.save(res, os.path.join(workdir, f"rank{rank}.pt"))
    dist.destroy_process_group()


# -- the inputs and the group -----------------------------------------------------------

@pytest.fixture(scope="module")
def inputs():
    yield pm._make_inputs(pm._REFS)
    pm._REFS.clear()         # the JAX references' arrays go with the module


@pytest.fixture(scope="module")
def groups(inputs):
    """{G: [rank outputs]}: one group of WORLD ranks, every rank a
    subprocess of this file bounded by tests/test_torch_process_mesh.py's
    RANK_TIMEOUT_S."""
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(inputs[0], os.path.join(tmp, "inputs.pt"))
        me = os.path.abspath(__file__)
        done = pm._start_group(lambda r, port: [sys.executable, me, str(r), str(port), tmp],
                               WORLD)
        for r, (rc, _, err) in enumerate(done):
            assert rc == 0, f"rank {r} exited {rc}:\n{err[-3000:]}"
        return {G: [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                    for r in range(WORLD)]}


# -- the mesh itself ----------------------------------------------------------------------

def test_the_hybrid_mesh_numbers_its_shards_rank_major(groups):
    """`process_mesh(local_devices=...)`, and `get_partitioner()` and
    `make_mesh()` with no argument on a record of two devices a rank
    (rank 1's with no collective): G = 4 shards, rank r's local shards 2r
    and 2r + 1, each running the global rows of a population of 10 padded
    to 12."""
    for r, res in enumerate(groups[G]):
        assert res["make_mesh"] == {"data": G, "model": 1} and res["default_is_hybrid"]
        d = res["describe"]
        assert (d["kind"], d["devices"], d["ranks"], d["rank"], d["local_shards"]) == \
            ("MeshPartitioner", G, WORLD, r, LOCAL)
        assert d["local_device_names"] == ["cpu"] * LOCAL and d["backend"] == "gloo"
        assert d["mesh_shape"] == {"data": G, "model": 1}
        assert res["own_shards"] == [(LOCAL * r + j, "cpu") for j in range(LOCAL)]
        assert res["rows"]["shards"] == [(g, G, "cpu", 3 * g, 3 * g + 3, 10)
                                         for g in range(LOCAL * r, LOCAL * r + LOCAL)]
        _same_bits(res["rows"]["out"], torch.arange(10.0) * 2.0, f"rank {r}'s rows")
        t = res["transport"]
        assert t["collectives"] > 0 and t["staging_copies"] == 0


def test_layout_card_and_cli_name_the_ranks_and_local_shards(groups):
    for res in groups[G]:
        assert res["layout"] == {
            "program": "toy", "population": 10, "pad": 2, "padded": 12, "devices": G,
            "pad_fraction": round(2 / 12, 6), "members_per_device": 3.0,
            "collective_bytes": 12 * 4 * 4 * (G - 1), "ranks": WORLD, "local_shards": LOCAL,
            "backend": "gloo"}
        assert f"{WORLD} rank(s) x {LOCAL} local shard(s) = {G} shards" in res["cli"]
        assert f"population 10 on {G} device(s): pad 2 → 12 lanes" in res["cli"]


def test_unequal_local_shard_counts_raise_on_every_rank(groups):
    for res in groups[G]:
        assert res["unequal"] is not None and "[1, 2] by rank" in res["unequal"]


# -- the seams: tests/test_torch_process_mesh.py's checks at world G ------------------------

@pytest.mark.parametrize("check", ["test_sweep", "test_run_ga", "test_tenant_engine",
                                   "test_lob_sweep", "test_train_pbt_generation",
                                   "test_evaluate_structures", "test_time_shard",
                                   "test_ring_attention_and_its_gradient"])
def test_seam(groups, inputs, check):
    getattr(pm, check)(groups, inputs, G)


def test_hpo_farm(groups, inputs, monkeypatch):
    """Trial i on global shard i mod 4 (rank (i mod 4) // 2, local device
    (i mod 4) mod 2): the single device's trials and losses bit for bit;
    with the training faked, JAX's trial sequence."""
    import jax
    from test_torch_train import _fake_train

    from ai_crypto_trader_tpu.models import hpo as jhpo
    from ai_crypto_trader_tpu_torch.models.hpo import trial_slot

    got = _ranks(groups, G, "hpo")
    one = pm._ref("hpo", None, inputs)
    assert got["real"] == one["real"] and got["fake"] == one["fake"]
    assert got["real"] == pm._ref("hpo", G, inputs)["real"]
    # 4 trials, then 2 finalists: rank 0 runs slots 0-1 of each rung, rank 1 slots 2-3
    farmed = [res["hpo_farmed"] for res in groups[G]]
    assert farmed == [sum(trial_slot(i, LOCAL, WORLD, r) is not None
                          for i in [*range(4), *range(2)]) for r in range(WORLD)] == [4, 2]
    monkeypatch.setattr(jhpo, "train_model", _fake_train)
    ref = jhpo.optimize_hyperparameters(jax.random.PRNGKey(0), inputs[0]["fake_features"],
                                        **pm.HPO_FAKE_KW)
    assert got["fake"] == ref


def test_trial_slot_is_the_global_shard_rank_major():
    from ai_crypto_trader_tpu_torch.models.hpo import trial_slot

    assert [[trial_slot(i, 2, 2, r) for r in range(2)] for i in range(9)] == \
        [[0, None], [1, None], [None, 0], [None, 1]] * 2 + [[0, None]]
    assert [trial_slot(i, 3) for i in range(4)] == [0, 1, 2, 0]    # one controller
    assert [trial_slot(i, 1, 3, 1) for i in range(4)] == [None, 0, None, None]


def test_ring_backward_with_the_loss_on_a_block_that_skips_the_others(groups, inputs):
    """The loss on the first block alone: every rank still runs every
    rotation's backward (none hangs), and the gradient is the dense one's:
    zero past the first block's keys and values."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ai_crypto_trader_tpu.parallel.ring_attention import reference_attention as jref

    got = _ranks(groups, G, "ring_first_block")
    tb = pm.T_RING // G
    q, k, v = (jnp.asarray(t.numpy()) for t in inputs[0]["qkv"])
    w = inputs[0]["weight"].numpy()[:tb]
    dgrads = jax.grad(lambda q, k, v: jnp.sum(jref(q, k, v, causal=True)[:tb] * w),
                      argnums=(0, 1, 2))(q, k, v)
    for g, d in zip(got["grads"], dgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(d), rtol=pm.LC_GRAD_RTOL,
                                   atol=pm.LC_GRAD_ATOL)
        assert not g[tb:].any()
    np.testing.assert_allclose(got["out"].numpy(), np.asarray(jref(q, k, v, causal=True)),
                               rtol=pm.LC_TOL, atol=pm.LC_TOL)


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
