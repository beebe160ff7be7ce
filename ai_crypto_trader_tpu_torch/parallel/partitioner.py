"""The Partitioner seam, single-device end.

Port of `ai_crypto_trader_tpu/parallel/partitioner.py`'s
`SingleDevicePartitioner` (:150-196) and `get_partitioner`: the PBT fleet
(`rl.population.train_pbt`) takes a partitioner as the JAX one does.  On
one card the fleet is one batch of stacked tensors on that card, so the
seam is the identity: `shard_population` returns the tree, and
`population_eval` returns the function (the fleet's tensors carry the
member axis themselves) — named, it records the program's layout card
with `utils.meshprof` (population, pad 0, one device) at each call, as the
JAX seam does at trace time.  `describe` is the operator's layout summary
(/state.json ``mesh`` block, ``cli mesh`` / ``cli status``).  A population spread over several cards — the
JAX package's `MeshPartitioner` — is not ported (ROADMAP item 15):
`train_pbt` refuses any other partitioner.
"""

from __future__ import annotations

import torch

from ai_crypto_trader_tpu_torch.utils import meshprof


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
        """``fn`` itself: the population's tensors carry the member axis.
        Named, each call records the layout card (pad 0, one device)."""
        if name is None:
            return fn

        def named(pop_tree, *repl):
            out = fn(pop_tree, *repl)
            if meshprof.active() is not None:
                from torch.utils._pytree import tree_leaves

                lead = next(x for x in tree_leaves(pop_tree) if torch.is_tensor(x))
                meshprof.record_population_layout(
                    name, population=int(lead.shape[0]), pad=0, devices=1,
                    out_tree=out)
            return out

        return named

    def trial_devices(self) -> list:
        """Host-farmed trials run in turn on the one card: no farm."""
        return []

    def describe(self) -> dict:
        """Partitioner kind, device count and the device kinds behind it:
        the CUDA card when there is one, else the CPU."""
        out = {"kind": type(self).__name__, "devices": self.device_count}
        if torch.cuda.is_available():
            out["device_kinds"] = [torch.cuda.get_device_name(0)]
            out["platform"] = "gpu"
        else:
            out["device_kinds"] = ["cpu"]
            out["platform"] = "cpu"
        return out

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
