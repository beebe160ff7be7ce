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
`default_mesh()` give a mesh whose data-axis shards are the group's ranks,
one device each (``cuda:(local_rank % cards)``, or the CPU for a group
brought up for it), as `jax.devices()` spans processes:

  * every rank holds the whole population (made from the same seed and
    draws: JAX's ``device_put`` of a global value), runs only its own
    shard in `shard_loop`, under `current_shard()` with its true index and
    rows;
  * `gather_tree` and `gather_shards` are an all-gather over the group:
    every rank ends with the whole output on its own device, as
    ``out_specs=P(axis)`` gives every process the global array; `rotate`
    and `exchange` are the point-to-point send/recv of the ring's K/V
    blocks and `time_shard`'s halos;
  * the transport is NCCL (``all_gather_into_tensor`` on the card
    tensors) when every rank of a host has a card of its own, else gloo:
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
    device: torch.device     # this rank's
    devices: tuple           # every rank's device (as that rank names it), rank order
    cards: int               # CUDA cards this rank sees (0 in a group for the CPU)
    group: object            # the data collectives' group (None: the default, gloo)
    world_group: object      # the default group it was built on
    token: int               # which bring-up: meshes of an earlier group never equal it


_PROCESS: ProcessGroupInfo | None = None


def _plan(hosts: Sequence[str], rank: int, cuda: bool, cards: int):
    """(local rank, local world, device, backend) of ``rank`` among the
    ranks on ``hosts`` (each rank's host name, in rank order): its card is
    ``cuda:(local_rank % cards)``, NCCL when no other rank of its host
    shares it."""
    local_rank = list(hosts[:rank]).count(hosts[rank])
    local_world = list(hosts).count(hosts[rank])
    if not cuda:
        return local_rank, local_world, torch.device("cpu"), "gloo"
    device = torch.device("cuda", local_rank % cards)
    return local_rank, local_world, device, "nccl" if local_world <= cards else "gloo"


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
    """The data axis over the ranks of the process group: shard i is rank
    i's device, this process runs shard ``rank``.  Built by `process_mesh`
    (`make_mesh` and `default_mesh` once a group of several ranks is up)."""

    spans_processes = True

    def __init__(self, info: ProcessGroupInfo, axis_names: Sequence[str] = ("data", "model")):
        grid = np.empty((info.world, 1), dtype=object)
        for r, d in enumerate(info.devices):
            grid[r, 0] = d
        super().__init__(grid, axis_names)
        self.info = info

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
        """This rank's device: where its shard runs and gathers land."""
        return self.info.device

    def split(self, x: torch.Tensor, dim: int = 0, axis: str | None = None) -> "Shards":
        """This rank's block of ``x`` along ``dim`` (one block a rank, the
        size must divide), on its device."""
        n, size = self.world, x.shape[dim]
        if size % n:
            raise ValueError(f"axis of {size} does not split over {n} shards; pad first")
        blk = size // n
        return Shards([x.narrow(dim, self.rank * blk, blk).to(self.local_device,
                                                               non_blocking=True)], mesh=self)

    def _key(self):
        return ("process", self.info.token, self.info.rank) + super()._key()

    def __repr__(self) -> str:
        return (f"ProcessMesh(rank {self.rank} of {self.world}, {self.backend}, "
                f"devices={list(self.info.devices)})")


def process_mesh(axis_names: tuple[str, str] = ("data", "model")) -> ProcessMesh:
    """The mesh of the group `initialize_distributed` brought up, at any
    world size (`make_mesh` builds it only over several ranks).  A rank
    that sees more CUDA cards than its host has ranks raises
    ``ValueError``: each rank owns one card, and a mesh of each rank's
    cards inside the process mesh is not built (ROADMAP item 35)."""
    info = process_group()
    if info is None:
        raise RuntimeError("no process group is up: call parallel.initialize_distributed first")
    if info.device.type == "cuda" and info.cards > info.local_world:
        raise ValueError(
            f"rank {info.rank} sees {info.cards} CUDA cards and its host runs "
            f"{info.local_world} rank(s): a process mesh gives each rank one card (a rank "
            "with several local cards is ROADMAP item 35); pin each rank to one card "
            "with CUDA_VISIBLE_DEVICES or start one rank a card")
    return ProcessMesh(info, axis_names)


def make_mesh(data_parallel: int = -1, model_parallel: int = 1, *,
              axis_names: tuple[str, str] = ("data", "model"),
              devices: Sequence | None = None) -> Mesh:
    """Build a 2-D (data, model) mesh.

    ``data_parallel=-1`` takes every remaining device.  ``devices`` (any
    ``torch.device`` specs, repeats allowed: a virtual mesh) defaults to
    every visible CUDA card; without CUDA it must be given (``RuntimeError``
    otherwise).  A mesh larger than the devices raises ``ValueError``.
    Without ``devices``, once `initialize_distributed` has brought up a
    group of several ranks, the mesh is the group's (`process_mesh`): its
    data axis is every rank (``data_parallel`` -1 or the world size,
    ``model_parallel`` 1; anything else raises ``ValueError``)."""
    if devices is None:
        info = _spanning()
        if info is not None:
            if model_parallel > 1 or data_parallel not in (-1, info.world):
                raise ValueError(
                    f"a process mesh is the {info.world} ranks on its data axis; asked "
                    f"for {data_parallel} data x {model_parallel} model")
            return process_mesh(axis_names)
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
    """Every rank of the process group once `initialize_distributed` has
    brought up one of several ranks, else every visible CUDA card on the
    data axis.  Cached per group: a group brought up later is seen."""
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
    its device — on a process mesh (``mesh``) this rank's block alone.
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
    of a process mesh are all-gathered over its group: every rank gets the
    whole."""
    mesh = getattr(shards, "mesh", None)
    if mesh is not None and mesh.spans_processes:
        x = all_gather(shards[0], mesh.info, dim)
        return x if device is None else x.to(device, non_blocking=True)
    dev = shards[0].device if device is None else torch.device(device)
    return torch.cat([s.to(dev, non_blocking=True) for s in shards], dim=dim)


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
    ``axis``, in mesh order, under `current_shard`; returns the outputs in
    mesh order.  ``sharded`` holds one per-shard sequence per argument
    (`Shards`, or any list of per-device pytrees), ``replicated_args`` go
    to every shard, copied once per distinct device.  ``population`` (the
    rows before padding) sizes each shard's `ShardInfo`; default: the
    shards' total rows.  Nothing is read back: each shard's work is issued
    and the next one's follows.

    On a process mesh each sequence holds this rank's shard alone (the
    shards are equal blocks), ``fn`` runs once, as shard ``rank``, and the
    list holds its output."""
    devs = mesh.axis_devices(axis)
    n = len(devs)
    if mesh.spans_processes:
        me, dev = mesh.rank, mesh.local_device
        rows = _rows([s[0] for s in sharded])
        total = rows * n if population is None else int(population)
        repl = replicate(tuple(replicated_args), [dev])[dev]
        with _running(ShardInfo(me, n, dev, me * rows, (me + 1) * rows, total)), _on_card(dev):
            return [fn(*(s[0] for s in sharded), *repl)]
    repl = replicate(tuple(replicated_args), devs)
    rows = [_rows([s[i] for s in sharded]) for i in range(n)]
    total = sum(rows) if population is None else int(population)
    outs, lo = [], 0
    for i, d in enumerate(devs):
        info = ShardInfo(i, n, d, lo, lo + rows[i], total)
        with _running(info), _on_card(d):
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
    (``outs`` this rank's output alone) each tensor leaf is all-gathered
    over the group, and a 0-d one is rank 0's (a broadcast): every rank
    gets the same tree."""
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
        x = (all_gather(leaf, mesh.info).to(device, non_blocking=True) if spans
             else gather_shards([f[0][j] for f in flat], device))
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
    be); the ranks then tell each other their hosts, each takes its device
    (``cuda:(local_rank % cards)``, or the CPU), and when every rank of
    every host has a card of its own the data transport is an NCCL group
    over all ranks.  Ranks that share a card (NCCL refuses two ranks on
    one device) and groups for the CPU keep gloo.  The bring-up and every
    collective time out after `COLLECTIVE_TIMEOUT`.  Returns the data
    transport's backend name ("nccl" or "gloo")."""
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
    plans = [_plan(hosts, r, cuda, c) for r, (_, c) in enumerate(peers)]
    local_rank, local_world, device, _ = plans[rank]
    backend = "nccl" if all(p[3] == "nccl" for p in plans) else "gloo"
    group = None
    if cuda:
        torch.cuda.set_device(device)
    if backend == "nccl":
        group = dist.new_group(backend="nccl", timeout=COLLECTIVE_TIMEOUT)
    _BRINGUPS += 1
    _PROCESS = ProcessGroupInfo(rank, world, local_rank, local_world, backend, device,
                                tuple(str(p[2]) for p in plans), peers[rank][1], group,
                                dist.group.WORLD, _BRINGUPS)
    return backend
