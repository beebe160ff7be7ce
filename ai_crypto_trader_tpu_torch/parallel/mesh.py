"""Device meshes, the shard loop and the process mesh.

Port of `ai_crypto_trader_tpu/parallel/mesh.py`.  The JAX package shards
arrays over a `jax.sharding.Mesh` and runs one SPMD program per device
under `shard_map`, with collectives (`all_gather`, `ppermute`, `psum`)
between them; after `jax.distributed.initialize` the mesh's devices are
those of every process.  Here a mesh takes one of two forms.

One controller: one host thread drives every device, as `nn.DataParallel`
does:

  * a `Mesh` is a [data, model] grid of ``torch.device``s.  A mesh of real
    cards runs each shard on its own card; a *virtual* mesh lists the same
    device n times (the tests' ``[torch.device("cpu")] * 8``, the JAX
    tests' 8 virtual CPU devices; ``[cuda:0] * 4`` on one card);
  * `shard_loop` issues a function on every shard in mesh order, with
    each shard's slice moved to its device and each replicated argument
    copied once per *distinct* device (on a virtual mesh nothing is
    copied).  Every shard is issued before anything is read, so the cards
    of a real mesh run concurrently;
  * a collective is a tensor move between shards (``.to(device,
    non_blocking=True)``) between the phases of a computation, and
    autograd follows the moves.  `gather_shards` is the all-gather onto
    one device.

A process mesh (`ProcessMesh`): after `initialize_distributed` brings up a
``torch.distributed`` group of several ranks, `make_mesh()` and
`default_mesh()` give a mesh whose data axis spans the group, as
`jax.devices()` spans processes.  Each rank drives L ≥ 1 local shards
(the same L on every rank), so the axis has G = world × L shards,
numbered rank-major: local shard j of rank r is global shard r·L + j.  By
default a rank takes its own cards (a host's cards split evenly among its
ranks, a contiguous block each), the CPU in a group brought up for it, or
its one card where ranks share cards; `process_mesh(local_devices=...)`
names them, repeats allowed (a virtual local mesh, ``["cuda:0"] * 2``):

  * every rank holds the whole population (made from the same seed and
    draws: JAX's ``device_put`` of a global value) and runs its own L
    shards in `shard_loop`, one controller over its local devices, each
    under `current_shard()` with its global index and rows;
  * within a rank, data moves as on one controller (``.to(device,
    non_blocking=True)``); between ranks, over the group: `gather_tree`
    and `gather_shards` join the rank's L blocks on its home device (its
    first local device, where gathers land) and all-gather them, so every
    rank ends with the whole output in global order, as
    ``out_specs=P(axis)`` gives every process the global array; `rotate`
    and `exchange` are the point-to-point send/recv of the ring's K/V
    blocks and `time_shard`'s halos across a rank boundary;
  * the transport is NCCL (``all_gather_into_tensor`` on the card
    tensors) when every rank of a host has cards of its own, else gloo:
    ranks that share a card (NCCL refuses two ranks on one device) and
    groups for the CPU.  On gloo a CUDA tensor is staged through pinned
    host memory (copy out, collective, copy back); `TRANSPORT` counts the
    collectives, their bytes and these staging copies.

`current_shard` is the counterpart of ``lax.axis_index``: inside a shard
loop it names the running shard and the rows it holds.
"""

from __future__ import annotations

import contextlib
import contextvars
import datetime
import functools
import socket
from typing import NamedTuple, Sequence

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from ai_crypto_trader_tpu_torch.device import resolve_device

# how long a rank waits for the others: at the group's bring-up and in every
# collective (a rank that dies makes the others fail after this, not hang)
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=300)


class Mesh:
    """A [data, model] grid of devices.  ``devices`` is a NumPy object
    array of ``torch.device``s; ``shape[axis]`` is the length of a named
    axis.  Two meshes over the same grid and names are equal (program
    caches key on them)."""

    spans_processes = False

    def __init__(self, grid, axis_names: Sequence[str]):
        self.devices = np.empty(np.shape(grid), dtype=object)
        for idx in np.ndindex(self.devices.shape):
            self.devices[idx] = torch.device(np.asarray(grid, dtype=object)[idx])
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"a {self.devices.ndim}-D grid needs as many axis names, "
                             f"got {self.axis_names}")
        self.shape = {a: int(n) for a, n in zip(self.axis_names, self.devices.shape)}

    def axis_devices(self, axis: str | None = None) -> list:
        """The devices along ``axis`` (default: the first), at index 0 of
        every other axis: the shards of a population split over it."""
        axis = self.axis_names[0] if axis is None else axis
        k = self.axis_names.index(axis)
        index = [0] * self.devices.ndim
        index[k] = slice(None)
        return list(self.devices[tuple(index)])

    def own_shards(self, axis: str | None = None) -> list:
        """(index, device) of the shards of ``axis`` this process runs, in
        mesh order: every shard on one controller."""
        return list(enumerate(self.axis_devices(axis)))

    def split(self, x: torch.Tensor, dim: int = 0, axis: str | None = None) -> "Shards":
        """``x`` cut into one block a shard of ``axis`` along ``dim``
        (`split_leading`): every block, each on its device."""
        return split_leading(x, self.axis_devices(axis), dim)

    def _key(self):
        return (tuple(str(d) for d in np.ravel(self.devices)), self.devices.shape,
                self.axis_names)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in np.ravel(self.devices)]})"


class ProcessGroupInfo(NamedTuple):
    """The group `initialize_distributed` brought up, as one rank sees it."""

    rank: int
    world: int
    local_rank: int          # among the ranks on this host
    local_world: int
    backend: str             # the data transport's: "nccl" or "gloo"
    device: torch.device     # this rank's home device (its first card, or the CPU)
    rank_devices: tuple      # every rank's default local devices (names), rank order
    cards: int               # CUDA cards this rank sees (0 in a group for the CPU)
    group: object            # the data collectives' group (None: the default, gloo)
    world_group: object      # the default group it was built on
    token: int               # which bring-up: meshes of an earlier group never equal it

    @property
    def devices(self) -> tuple:
        """Every rank's home device (as that rank names it), rank order."""
        return tuple(r[0] for r in self.rank_devices)


_PROCESS: ProcessGroupInfo | None = None


def _plan(hosts: Sequence[str], rank: int, cuda: bool, cards: int):
    """(local rank, local world, home device, backend) of ``rank`` among
    the ranks on ``hosts`` (each rank's host name, in rank order): the
    first of its cards (`local_cards`: a split that does not divide raises
    ``ValueError``), NCCL when no other rank of its host shares them; the
    CPU and gloo without CUDA."""
    local_rank = list(hosts[:rank]).count(hosts[rank])
    local_world = list(hosts).count(hosts[rank])
    if not cuda:
        return local_rank, local_world, torch.device("cpu"), "gloo"
    return (local_rank, local_world, local_cards(local_rank, local_world, cards)[0],
            "nccl" if cards >= local_world else "gloo")


def local_cards(local_rank: int, local_world: int, cards: int) -> list:
    """The cards a rank drives by default: a host whose ``local_world``
    ranks each see ``cards`` cards gives each rank a contiguous block of
    ``cards // local_world`` (one rank and 8 cards: all 8; 2 ranks: 4
    each); a split that does not divide raises ``ValueError``.  Ranks that
    share cards (fewer cards than ranks) drive one, ``cuda:(local_rank %
    cards)``."""
    if cards < local_world:
        return [torch.device("cuda", local_rank % cards)]
    if cards % local_world:
        raise ValueError(
            f"{cards} CUDA cards do not split evenly among the {local_world} ranks of "
            "this host; give each rank its cards with CUDA_VISIBLE_DEVICES")
    per = cards // local_world
    return [torch.device("cuda", local_rank * per + j) for j in range(per)]


def process_group() -> ProcessGroupInfo | None:
    """The group `initialize_distributed` brought up, while it is up (None
    before it, and after ``destroy_process_group``)."""
    import torch.distributed as dist

    info = _PROCESS
    if info is None or not dist.is_available() or not dist.is_initialized() \
            or dist.group.WORLD is not info.world_group:
        return None
    return info


def _spanning() -> ProcessGroupInfo | None:
    """The group when it has several ranks (the default meshes then span
    them), else None.  A group of several ranks that
    `initialize_distributed` did not bring up raises ``RuntimeError``:
    nothing falls back to the one-controller mesh on its own."""
    import torch.distributed as dist

    info = process_group()
    if info is None and dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        raise RuntimeError(
            f"a torch.distributed group of {dist.get_world_size()} ranks is up that "
            "parallel.initialize_distributed did not bring up; bring it up with that "
            "function to build a mesh over its ranks")
    return info if info is not None and info.world > 1 else None


class ProcessMesh(Mesh):
    """The data axis over the ranks of the process group, each rank
    driving L local shards: global shard g = r·L + j is local shard j of
    rank r, on that rank's ``rank_devices[r][j]`` (default: the group's
    record of each rank's own).  This process runs shards ``rank·L`` to
    ``rank·L + L − 1``.  Built by `process_mesh` (`make_mesh` and
    `default_mesh` once a group of several ranks is up)."""

    spans_processes = True

    def __init__(self, info: ProcessGroupInfo, axis_names: Sequence[str] = ("data", "model"),
                 rank_devices: Sequence[Sequence] | None = None):
        if rank_devices is None:
            rank_devices = info.rank_devices
        counts = [len(r) for r in rank_devices]
        if len(counts) != info.world or min(counts) < 1 or len(set(counts)) > 1:
            raise ValueError(
                f"the ranks drive different numbers of local shards: {counts} by rank; "
                f"every rank of a process mesh of {info.world} must drive the same "
                "number, at least one")
        grid = np.empty((sum(counts), 1), dtype=object)
        for g, d in enumerate(d for r in rank_devices for d in r):
            grid[g, 0] = d
        super().__init__(grid, axis_names)
        self.info = info
        self.local_count = counts[0]
        self.first_shard = info.rank * self.local_count
        self.local_devices = list(self.devices[self.first_shard:
                                               self.first_shard + self.local_count, 0])

    @property
    def rank(self) -> int:
        return self.info.rank

    @property
    def world(self) -> int:
        return self.info.world

    @property
    def backend(self) -> str:
        return self.info.backend

    @property
    def local_device(self) -> torch.device:
        """This rank's home device: its first local shard's, where gathers
        land and the transport's collectives run."""
        return self.local_devices[0]

    def own_shards(self, axis: str | None = None) -> list:
        """(global index, device) of this rank's L shards."""
        return [(self.first_shard + j, d) for j, d in enumerate(self.local_devices)]

    def split(self, x: torch.Tensor, dim: int = 0, axis: str | None = None) -> "Shards":
        """This rank's L blocks of ``x`` along ``dim`` (one block a global
        shard, the size must divide), each on its local device."""
        n, size = self.shape[self.axis_names[0]], x.shape[dim]
        if size % n:
            raise ValueError(f"axis of {size} does not split over {n} shards; pad first")
        blk = size // n
        return Shards([x.narrow(dim, g * blk, blk).to(d, non_blocking=True)
                       for g, d in self.own_shards()], mesh=self)

    def _key(self):
        return ("process", self.info.token, self.info.rank) + super()._key()

    def __repr__(self) -> str:
        return (f"ProcessMesh(rank {self.rank} of {self.world}, {self.local_count} local "
                f"shard(s) each, {self.backend}, "
                f"devices={[str(d) for d in np.ravel(self.devices)]})")


def process_mesh(axis_names: tuple[str, str] = ("data", "model"), *,
                 local_devices: Sequence | None = None) -> ProcessMesh:
    """The mesh of the group `initialize_distributed` brought up, at any
    world size (`make_mesh` builds it only over several ranks).  By
    default each rank drives its own cards (`local_cards`, or the CPU in
    a group brought up for it), as every rank recorded them at the
    bring-up: no collective.  ``local_devices`` (any ``torch.device``
    specs, repeats allowed: a virtual local mesh) names this rank's; every
    rank then calls it together, the ranks exchange their lists in one
    ``all_gather_object``, and unequal local shard counts raise
    ``ValueError`` on every rank.  Over NCCL the first local device must
    be the rank's home card, which the group was brought up on
    (``ValueError``)."""
    info = process_group()
    if info is None:
        raise RuntimeError("no process group is up: call parallel.initialize_distributed first")
    if local_devices is None:
        return ProcessMesh(info, axis_names)
    local = [str(torch.device(d)) for d in local_devices]
    if info.backend == "nccl" and local and torch.device(local[0]) != info.device:
        raise ValueError(f"rank {info.rank}'s first local device is {local[0]}, but its NCCL "
                         f"transport runs on {info.device}: list {info.device} first")
    return ProcessMesh(info, axis_names, all_gather_object(local, info))


def make_mesh(data_parallel: int = -1, model_parallel: int = 1, *,
              axis_names: tuple[str, str] = ("data", "model"),
              devices: Sequence | None = None) -> Mesh:
    """Build a 2-D (data, model) mesh.

    ``data_parallel=-1`` takes every remaining device.  ``devices`` (any
    ``torch.device`` specs, repeats allowed: a virtual mesh) defaults to
    every visible CUDA card; without CUDA it must be given (``RuntimeError``
    otherwise).  A mesh larger than the devices raises ``ValueError``.
    Without ``devices``, once `initialize_distributed` has brought up a
    group of several ranks, the mesh is the group's (`process_mesh`, each
    rank's own cards): its data axis is
    every rank's local shards (``data_parallel`` -1 or their number,
    ``model_parallel`` 1; anything else raises ``ValueError``)."""
    if devices is None:
        if _spanning() is not None:
            mesh = process_mesh(axis_names)
            shards = mesh.shape[axis_names[0]]
            if model_parallel > 1 or data_parallel not in (-1, shards):
                raise ValueError(
                    f"a process mesh is the {shards} shards of its {mesh.world} ranks on its "
                    f"data axis; asked for {data_parallel} data x {model_parallel} model")
            return mesh
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh builds a mesh of the visible CUDA cards and none is "
                "available; pass devices=[...] (e.g. [torch.device('cpu')] * 8)")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if model_parallel <= 0:
        model_parallel = 1
    if data_parallel == -1:
        data_parallel = n // model_parallel
    if data_parallel < 1 or data_parallel * model_parallel > n:
        raise ValueError(
            f"mesh ({data_parallel} data x {model_parallel} model) does not fit "
            f"the {n} available device(s)")
    grid = np.empty((data_parallel, model_parallel), dtype=object)
    for i, d in enumerate(devices[: data_parallel * model_parallel]):
        grid[i // model_parallel, i % model_parallel] = d
    return Mesh(grid, axis_names)


def group_token() -> int | None:
    """Which group the default meshes span: the bring-up's token while a
    group of several ranks is up, else None (program caches key on it)."""
    info = _spanning()
    return None if info is None else info.token


@functools.lru_cache(maxsize=4)
def _default_mesh(token: int | None) -> Mesh:
    return make_mesh()


def default_mesh() -> Mesh:
    """Every rank of the process group, each driving its own cards, once
    `initialize_distributed` has brought up one of several ranks (no
    collective: a rank may build it alone), else every visible CUDA card
    on the data axis.  Cached per group: a group brought up later is
    seen."""
    return _default_mesh(group_token())


default_mesh.cache_clear = _default_mesh.cache_clear


class Sharding(NamedTuple):
    """Where a tensor's axes go: ``spec[i]`` is the mesh axis that axis i
    splits over, or None (replicated).  An empty spec replicates."""

    mesh: Mesh
    spec: tuple

    @property
    def is_fully_replicated(self) -> bool:
        return all(s is None for s in self.spec)


def data_sharding(mesh: Mesh, ndim: int = 1) -> Sharding:
    """Shard the leading axis over the data axis, replicate the rest."""
    return Sharding(mesh, (mesh.axis_names[0],) + (None,) * (ndim - 1))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


class Shards(list):
    """A tensor split over a mesh axis: its blocks in mesh order, each on
    its device — on a process mesh (``mesh``) this rank's L blocks alone.
    `gather` (`gather_shards`) is the all-gather."""

    def __init__(self, blocks=(), mesh: Mesh | None = None):
        super().__init__(blocks)
        self.mesh = mesh

    def gather(self, device=None, dim: int = 0) -> torch.Tensor:
        return gather_shards(self, device, dim)


def split_leading(x: torch.Tensor, devices: Sequence, dim: int = 0) -> Shards:
    """``x`` cut into ``len(devices)`` equal blocks along ``dim``, block i
    moved to ``devices[i]`` (a view where it is already there).  The size
    must divide: callers pad first (`pad_to_multiple`)."""
    n = len(devices)
    size = x.shape[dim]
    if size % n:
        raise ValueError(f"axis of {size} does not split over {n} shards; pad first")
    blk = size // n
    return Shards(x.narrow(dim, i * blk, blk).to(d, non_blocking=True)
                  for i, d in enumerate(devices))


def gather_shards(shards: Sequence[torch.Tensor], device=None, dim: int = 0) -> torch.Tensor:
    """The blocks concatenated along ``dim`` on ``device`` (default: the
    first block's): the all-gather of a one-controller mesh.  The `Shards`
    of a process mesh are joined on the rank's home device and
    all-gathered over its group: every rank gets the whole, in global
    order."""
    mesh = getattr(shards, "mesh", None)
    if mesh is not None and mesh.spans_processes:
        x = all_gather(_joined(shards, mesh.local_device, dim), mesh.info, dim)
        return x if device is None else x.to(device, non_blocking=True)
    return _joined(shards, shards[0].device if device is None else device, dim)


def _joined(blocks: Sequence[torch.Tensor], device, dim: int = 0) -> torch.Tensor:
    """``blocks`` concatenated along ``dim`` on ``device``."""
    dev = torch.device(device)
    return torch.cat([b.to(dev, non_blocking=True) for b in blocks], dim=dim)


def shard_leading_axis(mesh: Mesh, tree, axis: str | None = None):
    """Every tensor leaf of ``tree`` split on its leading axis over the
    mesh axis ``axis`` (default: the data axis): each becomes `Shards`,
    block i on device i (on a process mesh, this rank's block).  Leading
    sizes must divide the axis size (`pad_to_multiple` first)."""
    return tree_map(lambda x: mesh.split(x, 0, axis) if torch.is_tensor(x) else x, tree)


def pad_to_multiple(x, multiple: int, axis: int = 0, pad_value=0.0):
    """Pad ``x`` (a tensor or an array) along ``axis`` so its size divides
    over a mesh axis.  Returns (padded, original_size)."""
    size = x.shape[axis]
    rem = (-size) % multiple
    if rem == 0:
        return x, size
    if torch.is_tensor(x):
        shape = list(x.shape)
        shape[axis] = rem
        fill = torch.full(shape, pad_value, dtype=x.dtype, device=x.device)
        return torch.cat([x, fill], dim=axis), size
    widths = [(0, 0)] * np.ndim(x)
    widths[axis] = (0, rem)
    return np.pad(np.asarray(x), widths, constant_values=pad_value), size


# -- the shard loop ------------------------------------------------------------

class ShardInfo(NamedTuple):
    """The running shard of a shard loop: its index among ``count``, its
    device, and the rows [lo, hi) of a ``population`` (padded rows, hi >
    population, repeat the last member)."""

    index: int
    count: int
    device: torch.device
    lo: int
    hi: int
    population: int

    def take(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This shard's rows of a whole-population ``x`` along ``dim``;
        padded rows repeat the last member's."""
        if self.hi <= self.population:
            return x.narrow(dim, self.lo, self.hi - self.lo)
        rows = torch.arange(self.lo, self.hi, device=x.device).clamp_max(self.population - 1)
        return x.index_select(dim, rows)


_SHARD: contextvars.ContextVar = contextvars.ContextVar("mesh_shard", default=None)


def current_shard() -> ShardInfo | None:
    """The shard a shard loop is running (None outside one): the
    counterpart of ``lax.axis_index``."""
    return _SHARD.get()


@contextlib.contextmanager
def _running(info: ShardInfo):
    token = _SHARD.set(info)
    try:
        yield info
    finally:
        _SHARD.reset(token)


def replicate(tree, devices: Sequence) -> dict:
    """``{device: tree on it}``, each tensor leaf copied once per distinct
    device (where a leaf already is, it is not copied)."""
    return {d: tree_map(lambda x: x.to(d, non_blocking=True) if torch.is_tensor(x) else x,
                        tree)
            for d in dict.fromkeys(devices)}


def _rows(tree) -> int:
    leaves = [x for x in tree_flatten(tree)[0] if torch.is_tensor(x)]
    return int(leaves[0].shape[0]) if leaves else 0


def shard_loop(fn, mesh: Mesh, sharded: Sequence, replicated_args=(), *,
               axis: str | None = None, population: int | None = None) -> list:
    """Run ``fn(*sharded_i, *replicated_args)`` on every shard i of
    ``axis`` this process runs (`Mesh.own_shards`), in mesh order, under
    `current_shard`; returns the outputs in that order.  ``sharded`` holds
    one per-shard sequence per argument (`Shards`, or any list of
    per-device pytrees), ``replicated_args`` go to every shard, copied once
    per distinct device.  ``population`` (the rows before padding) sizes
    each shard's `ShardInfo`; default: the shards' total rows.  Nothing is
    read back: each shard's work is issued and the next one's follows.

    On a process mesh each sequence holds this rank's L shards alone (the
    shards are equal blocks), ``fn`` runs L times, as global shards
    ``rank·L`` to ``rank·L + L − 1``, and the list holds their outputs."""
    own = mesh.own_shards(axis)
    n = len(mesh.axis_devices(axis))
    repl = replicate(tuple(replicated_args), [d for _, d in own])
    rows = [_rows([s[i] for s in sharded]) for i in range(len(own))]
    if population is not None:
        total = int(population)
    else:
        total = rows[0] * n if mesh.spans_processes else sum(rows)
    outs, lo = [], own[0][0] * rows[0]           # shards before this process's: equal blocks
    for i, (g, d) in enumerate(own):
        with _running(ShardInfo(g, n, d, lo, lo + rows[i], total)), _on_card(d):
            outs.append(fn(*(s[i] for s in sharded), *repl[d]))
        lo += rows[i]
    return outs


def _on_card(d: torch.device):
    """A kernel launched through its C entry runs on the current card."""
    return torch.cuda.device(d) if d.type == "cuda" else contextlib.nullcontext()


def gather_tree(outs: Sequence, device, population: int | None = None, *,
                mesh: Mesh | None = None):
    """The per-shard output pytrees of a shard loop joined along their
    leading axis on ``device``, sliced to ``population`` rows; a leaf that
    is not a tensor (None, a scalar) is shard 0's.  On a process ``mesh``
    (``outs`` this rank's L outputs) each tensor leaf's L blocks are joined
    on ``device`` and all-gathered over the group, and a 0-d one is global
    shard 0's (rank 0's first, broadcast): every rank gets the same
    tree."""
    flat = [tree_flatten(o) for o in outs]
    spec = flat[0][1]
    spans = mesh is not None and mesh.spans_processes
    joined = []
    for j, leaf in enumerate(flat[0][0]):
        if not torch.is_tensor(leaf):
            joined.append(leaf)
            continue
        if leaf.ndim == 0:
            joined.append(broadcast(leaf, mesh.info) if spans else leaf)
            continue
        blocks = [f[0][j] for f in flat]
        x = (all_gather(_joined(blocks, device), mesh.info) if spans
             else _joined(blocks, device))
        joined.append(x if population is None else x[:population])
    return tree_unflatten(joined, spec)


# -- the process group and its transport ----------------------------------------

class Transport:
    """What a process mesh's collectives moved, on this rank: the
    collectives issued (all-gathers, broadcasts, send/recv exchanges), the
    payload bytes this rank sent, and the staging copies between a CUDA
    tensor and pinned host memory that a gloo group needs (each copy and
    its bytes).  `reset` zeroes them."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.collectives = 0
        self.bytes = 0
        self.staging_copies = 0
        self.staging_bytes = 0

    def counts(self) -> dict:
        return {"collectives": self.collectives, "bytes": self.bytes,
                "staging_copies": self.staging_copies, "staging_bytes": self.staging_bytes}


TRANSPORT = Transport()


def _staged(info: ProcessGroupInfo, x: torch.Tensor) -> bool:
    return info.backend == "gloo" and x.device.type == "cuda"


def _outgoing(x: torch.Tensor, info: ProcessGroupInfo) -> torch.Tensor:
    """``x`` as the transport takes it, as bytes: a CUDA tensor on gloo
    copied into pinned host memory first (the copy waits for the card)."""
    x = x.detach().contiguous()
    if _staged(info, x):
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x)
        TRANSPORT.staging_copies += 1
        TRANSPORT.staging_bytes += host.nbytes
        x = host
    TRANSPORT.bytes += x.nbytes
    return x.reshape(-1).view(torch.uint8)


def _buffer(nbytes: int, like: torch.Tensor, info: ProcessGroupInfo, rows: int = 1):
    """A [rows, nbytes] receive buffer: pinned host memory where ``like``
    is staged, else on its device."""
    if _staged(info, like):
        return torch.empty((rows, nbytes), dtype=torch.uint8, pin_memory=True)
    return torch.empty((rows, nbytes), dtype=torch.uint8, device=like.device)


def _incoming(buf: torch.Tensor, like: torch.Tensor, shape) -> torch.Tensor:
    """Received bytes as a tensor of ``like``'s dtype and ``shape`` on its
    device (a staged buffer copied back without waiting)."""
    y = buf.view(like.dtype).reshape(shape)
    if y.device != like.device:
        TRANSPORT.staging_copies += 1
        TRANSPORT.staging_bytes += y.nbytes
        y = y.to(like.device, non_blocking=True)
    return y


def all_gather(x: torch.Tensor, info: ProcessGroupInfo, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` (the same shape and dtype on each), joined along
    ``dim`` in rank order on ``x``'s device: every rank gets the whole.
    NCCL gathers the card tensors with ``all_gather_into_tensor``; gloo
    gathers host bytes."""
    import torch.distributed as dist

    if x.ndim == 0:
        x = x.reshape(1)
    lead = x.movedim(dim, 0)
    shape = (info.world * lead.shape[0],) + tuple(lead.shape[1:])
    TRANSPORT.collectives += 1
    wire = _outgoing(lead, info)
    buf = _buffer(wire.numel(), x, info, rows=info.world)
    if wire.numel():
        if info.backend == "nccl":
            dist.all_gather_into_tensor(buf.view(-1), wire, group=info.group)
        else:
            dist.all_gather(list(buf.unbind(0)), wire, group=info.group)
    return _incoming(buf, x, shape).movedim(0, dim)


def broadcast(x: torch.Tensor, info: ProcessGroupInfo, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``x`` on every rank (a new tensor on ``x``'s device)."""
    import torch.distributed as dist

    TRANSPORT.collectives += 1
    wire = _outgoing(x, info)
    buf = _buffer(wire.numel(), x, info)
    buf[0].copy_(wire)
    if wire.numel():
        dist.broadcast(buf[0], src, group=info.group)
    return _incoming(buf, x, x.shape)


def exchange(x: torch.Tensor, info: ProcessGroupInfo, send_to: int | None,
             recv_from: int | None) -> torch.Tensor | None:
    """Point-to-point, in one `batch_isend_irecv`: ``x`` sent to rank
    ``send_to`` and a tensor of ``x``'s shape and dtype received from rank
    ``recv_from`` (None: no send, no receive); returns what was received
    (None without a receive).  Every rank of the group calls it together."""
    import torch.distributed as dist

    TRANSPORT.collectives += 1
    nbytes = x.numel() * x.element_size()
    buf = _buffer(nbytes, x, info)[0]
    ops = []
    if send_to is not None:
        ops.append(dist.P2POp(dist.isend, _outgoing(x, info), send_to, group=info.group))
    if recv_from is not None:
        ops.append(dist.P2POp(dist.irecv, buf, recv_from, group=info.group))
    if ops and nbytes:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return None if recv_from is None else _incoming(buf, x, x.shape)


def rotate(x: torch.Tensor, info: ProcessGroupInfo, shift: int = 1) -> torch.Tensor:
    """The ring's step: ``x`` handed to rank + ``shift`` and rank −
    ``shift``'s received (``x`` itself on a group of one)."""
    if info.world == 1:
        return x
    r, n = info.rank, info.world
    return exchange(x, info, (r + shift) % n, (r - shift) % n)


def all_gather_object(obj, info: ProcessGroupInfo) -> list:
    """Every rank's picklable ``obj``, in rank order, over the default
    (gloo) group: host values only, so it never waits for a card."""
    import torch.distributed as dist

    out = [None] * info.world
    dist.all_gather_object(out, obj, group=info.world_group)
    return out


_BRINGUPS = 0


def initialize_distributed(coordinator: str | None = None, num_processes: int | None = None,
                           process_id: int | None = None, *, device=None) -> str:
    """Bring up the ``torch.distributed`` process group (the JAX package's
    `jax.distributed.initialize`).  Without ``coordinator`` the group reads
    ``env://`` (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK); with one
    (``host:port``) it is ``tcp://`` with ``num_processes`` and
    ``process_id``.  ``device=None`` means the card (``RuntimeError``
    without CUDA); ``"cpu"`` a group for the CPU.

    The group is gloo (host values, and the transport where NCCL cannot
    be); the ranks then tell each other their hosts and card counts, and
    each records every rank's cards (`local_cards`: a block of its host's
    cards, ``cuda:(local_rank % cards)`` where ranks share cards, or the
    CPU; a split that does not divide raises ``ValueError`` on every rank
    and takes the group down).  When every rank of every host has cards
    of its own the data transport is an NCCL group over all ranks; ranks
    that share a card (NCCL refuses two ranks on one device) and groups
    for the CPU keep gloo.  The bring-up and every collective time out
    after `COLLECTIVE_TIMEOUT`.  Returns the data transport's backend name
    ("nccl" or "gloo")."""
    import torch.distributed as dist

    global _PROCESS, _BRINGUPS
    dev = resolve_device(device)
    if coordinator is None:
        dist.init_process_group("gloo", init_method="env://", timeout=COLLECTIVE_TIMEOUT)
    else:
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id,
                                timeout=COLLECTIVE_TIMEOUT)
    rank, world = dist.get_rank(), dist.get_world_size()
    cuda = dev.type == "cuda"
    peers = [None] * world
    dist.all_gather_object(peers, (socket.gethostname(),
                                   torch.cuda.device_count() if cuda else 0))
    hosts = [h for h, _ in peers]
    try:
        plans = [_plan(hosts, r, cuda, c) for r, (_, c) in enumerate(peers)]
    except ValueError:
        dist.destroy_process_group()
        raise
    rank_devices = tuple(tuple(map(str, local_cards(p[0], p[1], c))) if cuda else ("cpu",)
                         for p, (_, c) in zip(plans, peers))
    local_rank, local_world, device, _ = plans[rank]
    backend = "nccl" if all(p[3] == "nccl" for p in plans) else "gloo"
    group = None
    if cuda:
        torch.cuda.set_device(device)
    if backend == "nccl":
        group = dist.new_group(backend="nccl", timeout=COLLECTIVE_TIMEOUT)
    _BRINGUPS += 1
    _PROCESS = ProcessGroupInfo(rank, world, local_rank, local_world, backend, device,
                                rank_devices, peers[rank][1], group, dist.group.WORLD,
                                _BRINGUPS)
    return backend
