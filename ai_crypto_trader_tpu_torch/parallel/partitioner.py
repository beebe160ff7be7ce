"""The Partitioner seam: ONE object that decides how population programs
land on the devices.

Port of `ai_crypto_trader_tpu/parallel/partitioner.py`.  Every population
program of the port (the backtest sweep, the GA's fitness, the tenant
engine's decide, the LOB sweep, the PBT generation, the structure pool,
HPO's trials) writes its computation for a batch of members and hands it
to ``partitioner.population_eval``:

  * `SingleDevicePartitioner` returns the function: the population's
    tensors carry the member axis themselves;
  * `MeshPartitioner` splits the population over the mesh's data axis
    (`parallel.mesh`): a ragged population pads by repeating its last
    member, each shard runs on its device with the replicated arguments
    copied once to each distinct device, and every output's population
    axis is gathered onto the mesh's first device and the pad sliced off.
    Every shard is issued before anything is read.  On a process mesh
    (`parallel.mesh.ProcessMesh`, after `initialize_distributed`) every
    rank holds the whole population, pads it the same way, takes the rows
    of its L local shards (global shards rank·L to rank·L + L − 1, each
    on its local device), runs ``fn`` on each, joins their outputs on its
    home device and all-gathers every output leaf over the group: the
    result is the same on every rank, on its own home device.

Members are independent, so a mesh computes exactly the single device's
per-member values: a 1-device mesh, and an n-way one, equal the
single-device seam bit for bit wherever a member's arithmetic does not
depend on the batch it sits in (tests/test_torch_mesh_partitioner.py).

Named, a program records its layout card with `utils.meshprof` (its
population, pad and devices) at each call.  `match_partition_rules` maps a
tree's leaves to partition specs (tuples of axis names or None).
"""

from __future__ import annotations

import functools
import re

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from ai_crypto_trader_tpu_torch.parallel.mesh import (
    TRANSPORT, Mesh, Sharding, ShardInfo, all_gather_object, default_mesh, gather_tree,
    group_token, shard_leading_axis, shard_loop)
from ai_crypto_trader_tpu_torch.utils import meshprof


def _path_name(path) -> str:
    """'/'-joined tree path."""
    parts = []
    for k in path:
        for attr in ("key", "name", "idx"):
            if hasattr(k, attr):
                parts.append(str(getattr(k, attr)))
                break
        else:
            parts.append(str(k))
    return "/".join(parts)


def match_partition_rules(rules, tree):
    """A tree of partition specs (tuples of mesh axis names or None) chosen
    by the first regex matching each leaf's '/'-joined path.  A scalar (or
    one-element) leaf is never partitioned (``()``); a leaf no rule
    covers raises ``ValueError``."""
    from torch.utils._pytree import tree_map_with_path

    def spec_for(path, leaf):
        shape = tuple(np.shape(leaf))
        if len(shape) == 0 or int(np.prod(shape)) == 1:
            return ()
        name = _path_name(path)
        for rule, ps in rules:
            if re.search(rule, name) is not None:
                return tuple(ps)
        raise ValueError(f"no partition rule matches leaf {name!r}")

    # tuple specs must not be walked into: map over the leaves only
    return tree_map_with_path(spec_for, tree)


def _lead(tree) -> torch.Tensor:
    return next(x for x in tree_flatten(tree)[0] if torch.is_tensor(x))


class Partitioner:
    """A partitioning policy."""

    mesh: Mesh | None = None
    axis: str | None = None

    @property
    def device_count(self) -> int:
        raise NotImplementedError

    def population_sharding(self, ndim: int = 1):
        """The sharding of a [pop, ...] tensor (None: the one device)."""
        raise NotImplementedError

    def shard_population(self, tree):
        raise NotImplementedError

    def population_eval(self, fn, name: str | None = None, donate_pop: bool = False):
        """``fn(pop_tree, *replicated) -> out_tree`` over the population.
        ``name`` records the program's layout card with `utils.meshprof`.
        ``donate_pop`` is accepted for the JAX package's signature and does
        nothing: PyTorch frees a buffer when its last reference goes, and
        no program here aliases its population onto an output."""
        raise NotImplementedError

    def trial_devices(self) -> list:
        raise NotImplementedError

    def pad_for(self, population: int) -> int:
        """Members `population_eval` appends (by repeating the last one) to
        split ``population`` evenly over the devices: 0 on one device or
        whenever the population divides the mesh axis."""
        return (-population) % max(self.device_count, 1)

    def _device_list(self) -> list:
        return [torch.device("cuda" if torch.cuda.is_available() else "cpu")]

    def describe(self) -> dict:
        """Operator-facing layout (/state.json ``mesh`` block, ``cli mesh``
        / ``cli status``): the kind, the device count and the kinds of the
        devices behind it."""
        out = {"kind": type(self).__name__, "devices": self.device_count}
        devs = self._device_list()
        out["device_kinds"] = sorted({torch.cuda.get_device_name(d) if d.type == "cuda"
                                      else d.type for d in devs})
        out["platform"] = "gpu" if devs and devs[0].type == "cuda" else "cpu"
        return out


class SingleDevicePartitioner(Partitioner):
    """Every program runs on the one device.  All instances compare equal."""

    def __eq__(self, other) -> bool:
        return type(other) is SingleDevicePartitioner

    def __hash__(self) -> int:
        return hash(SingleDevicePartitioner)

    @property
    def device_count(self) -> int:
        return 1

    def population_sharding(self, ndim: int = 1):
        return None

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
                meshprof.record_population_layout(
                    name, population=int(_lead(pop_tree).shape[0]), pad=0, devices=1,
                    out_tree=out)
            return out

        return named

    def trial_devices(self) -> list:
        """Host-farmed trials run in turn on the one device: no farm."""
        return []


class MeshPartitioner(Partitioner):
    """The population axis split over one mesh axis; outputs gathered onto
    the mesh's first device — on a process mesh onto every rank's own.
    ``axis`` defaults to the mesh's first ("data") axis.  A 1-device mesh
    is legal and equals `SingleDevicePartitioner` bit for bit."""

    def __init__(self, mesh: Mesh | None = None, axis: str | None = None):
        self.mesh = mesh if mesh is not None else default_mesh()
        self.axis = axis if axis is not None else self.mesh.axis_names[0]

    def __eq__(self, other) -> bool:
        return (type(other) is MeshPartitioner and other.mesh == self.mesh
                and other.axis == self.axis)

    def __hash__(self) -> int:
        return hash((MeshPartitioner, self.mesh, self.axis))

    @property
    def device_count(self) -> int:
        return int(self.mesh.shape[self.axis])

    @property
    def devices(self) -> list:
        """The shards' devices, in mesh order."""
        return self.mesh.axis_devices(self.axis)

    @property
    def home(self) -> torch.device:
        """Where gathered outputs land: the mesh's first device, on a
        process mesh this rank's home device (its first local one)."""
        return self.mesh.local_device if self.mesh.spans_processes else self.devices[0]

    def population_sharding(self, ndim: int = 1) -> Sharding:
        return Sharding(self.mesh, (self.axis,) + (None,) * (ndim - 1))

    def shard_population(self, tree):
        """Every tensor leaf split on its leading axis over the mesh axis
        (`parallel.mesh.Shards`; the size must divide — `population_eval`
        pads a ragged population itself)."""
        return shard_leading_axis(self.mesh, tree, self.axis)

    def _split(self, pop_tree):
        """(per-shard pytrees, population, pad): the population padded by
        repeating its last member and cut into one block per device; on a
        process mesh only this rank's L blocks (the others' are theirs to
        take), each on its local device."""
        leaves, spec = tree_flatten(pop_tree)
        pop = int(_lead(pop_tree).shape[0])
        n = self.device_count
        pad = (-pop) % n
        blk = (pop + pad) // n
        shards = []
        for i, d in self.mesh.own_shards(self.axis):
            info = ShardInfo(i, n, d, i * blk, (i + 1) * blk, pop)
            # a leaf without a member axis is the object itself, a 0-d tensor copied
            part = [x if not torch.is_tensor(x) else
                    (x if x.ndim == 0 else info.take(x)).to(info.device, non_blocking=True)
                    for x in leaves]
            shards.append(tree_unflatten(part, spec))
        return shards, pop, pad

    def _agree(self, pop_tree, name) -> None:
        """On a process mesh: every rank must hold the same population
        (its size and every tensor leaf's shape and dtype), or each raises
        ``ValueError`` before any collective of the program."""
        sig = (int(_lead(pop_tree).shape[0]),
               [(tuple(x.shape), str(x.dtype)) for x in tree_flatten(pop_tree)[0]
                if torch.is_tensor(x)])
        seen = all_gather_object(sig, self.mesh.info)
        if any(other != sig for other in seen):
            raise ValueError(
                f"the ranks hold different populations for {name or 'a program'}: sizes "
                f"{[other[0] for other in seen]} by rank (or other leaf shapes); every "
                "rank must hold the whole population, made from the same seed and draws")

    def population_eval(self, fn, name: str | None = None, donate_pop: bool = False):
        """``fn(pop_tree, *replicated) -> out_tree`` split over the mesh
        axis: the population pads to a multiple of the device count by
        repeating its last member, shard i's rows go to device i, each
        replicated argument is copied once per distinct device, ``fn`` runs
        on every shard in mesh order (under `parallel.mesh.current_shard`),
        and every output leaf's population axis is gathered onto the mesh's
        first device and sliced back to the population.  Nothing is read
        back.  Named, each call records the layout card (population, pad,
        devices, the all-gather's bytes, the device names; on a process
        mesh the ranks, the local shards a rank and the backend too).  On a
        process mesh each rank runs its own L shards and the outputs are
        all-gathered over the group; ranks that hold different populations
        raise ``ValueError``."""
        n_dev = self.device_count
        dev_names = tuple(str(d) for d in self.devices)
        spans = self.mesh.spans_processes
        ranks = ({"ranks": self.mesh.world, "local_shards": self.mesh.local_count,
                  "backend": self.mesh.backend} if spans else {})

        def sharded(pop_tree, *repl):
            if spans:
                self._agree(pop_tree, name)
            shards, pop, pad = self._split(pop_tree)
            outs = shard_loop(fn, self.mesh, [shards], repl, axis=self.axis, population=pop)
            padded = gather_tree(outs, self.home, mesh=self.mesh)
            if name is not None and meshprof.active() is not None:
                meshprof.record_population_layout(
                    name, population=pop, pad=pad, devices=n_dev, out_tree=padded,
                    device_names=dev_names, **ranks)
            if not pad:
                return padded
            return tree_map(lambda x: x[:pop] if torch.is_tensor(x) and x.ndim >= 1
                            and x.shape[0] == pop + pad else x, padded)

        return sharded

    def trial_devices(self) -> list:
        """Round-robin devices for host-farmed trials (HPO); on a process
        mesh this rank's local devices, which run its trials
        (`models.hpo`)."""
        return self._device_list()

    def _device_list(self) -> list:
        if self.mesh.spans_processes:
            return list(self.mesh.local_devices)  # another rank's cards are not this one's
        return list(np.ravel(self.mesh.devices))

    def describe(self) -> dict:
        """`Partitioner.describe` with the axis, the mesh's shape and its
        devices' names; on a process mesh also the ranks, this rank, the
        local shards a rank and this rank's devices, the backend and what
        the transport has moved (`parallel.mesh.TRANSPORT`: collectives,
        bytes, staging copies).  ``devices`` counts the global shards."""
        out = super().describe()
        out["axis"] = self.axis
        out["mesh_shape"] = {str(a): int(self.mesh.shape[a]) for a in self.mesh.axis_names}
        out["device_names"] = [str(d) for d in np.ravel(self.mesh.devices)]
        if self.mesh.spans_processes:
            out.update(ranks=self.mesh.world, rank=self.mesh.rank,
                       local_shards=self.mesh.local_count,
                       local_device_names=[str(d) for d in self.mesh.local_devices],
                       backend=self.mesh.backend, transport=TRANSPORT.counts())
        return out


@functools.lru_cache(maxsize=8)
def _default_partitioner(n_devices: int, group: int | None = None) -> Partitioner:
    # ``group`` (a bring-up's token) keys the cache only: a process group
    # brought up later gets a partitioner of its own mesh
    if n_devices <= 1:
        return SingleDevicePartitioner()
    return MeshPartitioner(default_mesh())


def get_partitioner(mesh: Mesh | None = None) -> Partitioner:
    """The default seam: a `MeshPartitioner` over every rank of the process
    group, each driving its own cards, once
    `parallel.initialize_distributed` has brought up one of several ranks
    (as JAX counts ``jax.device_count()`` across processes),
    else over every visible CUDA card when there is more than one, else
    `SingleDevicePartitioner` (the JAX package's rule: a mesh only over
    more than one device).  An explicit
    ``mesh`` pins the topology: one device on its data axis gives the
    single-device seam."""
    if mesh is not None:
        if not isinstance(mesh, Mesh):
            raise TypeError(f"{type(mesh).__name__} is not a parallel.mesh.Mesh")
        if mesh.shape[mesh.axis_names[0]] <= 1:
            return SingleDevicePartitioner()
        return MeshPartitioner(mesh)
    token = group_token()
    if token is not None:
        mesh = default_mesh()
        return _default_partitioner(mesh.shape[mesh.axis_names[0]], token)
    n = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return _default_partitioner(n)


def resolve_partitioner(partitioner) -> Partitioner:
    """``partitioner`` (None: the single-device seam) if it is one of this
    package's; anything else — another package's partitioner included —
    raises ``TypeError``."""
    if partitioner is None:
        return SingleDevicePartitioner()
    if not isinstance(partitioner, Partitioner):
        raise TypeError(
            f"{type(partitioner).__module__}.{type(partitioner).__name__} is not a "
            "partitioner of ai_crypto_trader_tpu_torch; pass None, "
            "parallel.get_partitioner() or a parallel.MeshPartitioner")
    return partitioner
