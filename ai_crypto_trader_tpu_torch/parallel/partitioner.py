"""The Partitioner seam, single-device end.

Port of `ai_crypto_trader_tpu/parallel/partitioner.py`'s
`SingleDevicePartitioner` (:150-196) and `get_partitioner`: the PBT fleet
(`rl.population.train_pbt`) takes a partitioner as the JAX one does.  On
one card the fleet is one batch of stacked tensors on that card, so the
seam is the identity: `shard_population` returns the tree, and
`population_eval` returns the function (the fleet's tensors carry the
member axis themselves).  A population spread over several cards — the
JAX package's `MeshPartitioner` — is not ported (ROADMAP item 15):
`train_pbt` refuses any other partitioner.
"""

from __future__ import annotations


class SingleDevicePartitioner:
    """Every program runs on the one card.  All instances compare equal."""

    def __eq__(self, other) -> bool:
        return type(other) is SingleDevicePartitioner

    def __hash__(self) -> int:
        return hash(SingleDevicePartitioner)

    @property
    def device_count(self) -> int:
        return 1

    def shard_population(self, tree):
        return tree

    def population_eval(self, fn, name: str | None = None, donate_pop: bool = False):
        """``fn`` itself: the population's tensors carry the member axis."""
        return fn

    def pad_for(self, population: int) -> int:
        """Members added to fill the devices: none on one card."""
        return 0


def get_partitioner(mesh=None) -> SingleDevicePartitioner:
    """The single-device seam.  A mesh (several cards) is not ported yet:
    ROADMAP item 15."""
    if mesh is not None:
        raise NotImplementedError(
            "a partitioner over a mesh of several cards is not ported yet: ROADMAP item 15")
    return SingleDevicePartitioner()


def require_single(partitioner) -> SingleDevicePartitioner:
    """``partitioner`` (None: the default) if it is the single-device seam;
    any other raises ``NotImplementedError`` naming ROADMAP item 15."""
    if partitioner is None:
        return SingleDevicePartitioner()
    if not isinstance(partitioner, SingleDevicePartitioner):
        raise NotImplementedError(
            f"{type(partitioner).__name__}: a population over several cards is not "
            "ported yet (ROADMAP item 15); pass partitioner=None")
    return partitioner
