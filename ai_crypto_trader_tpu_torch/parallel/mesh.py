"""Device meshes and the shard loop: one controller driving a list of devices.

Port of `ai_crypto_trader_tpu/parallel/mesh.py`.  The JAX package shards
arrays over a `jax.sharding.Mesh` and runs one SPMD program per device
under `shard_map`, with collectives (`all_gather`, `ppermute`, `psum`)
between them.  Here one host thread drives every device, as
`nn.DataParallel` does:

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

`current_shard` is the counterpart of ``lax.axis_index``: inside a shard
loop it names the running shard and the rows it holds.

`initialize_distributed` brings up a ``torch.distributed`` process group
(NCCL on the card, gloo when the caller asks for the CPU).  A mesh that
spans processes is not built from it yet (ROADMAP item 33).
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
from typing import NamedTuple, Sequence

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from ai_crypto_trader_tpu_torch.device import resolve_device


class Mesh:
    """A [data, model] grid of devices.  ``devices`` is a NumPy object
    array of ``torch.device``s; ``shape[axis]`` is the length of a named
    axis.  Two meshes over the same grid and names are equal (program
    caches key on them)."""

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

    def _key(self):
        return (tuple(str(d) for d in np.ravel(self.devices)), self.devices.shape,
                self.axis_names)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in np.ravel(self.devices)]})"


def make_mesh(data_parallel: int = -1, model_parallel: int = 1, *,
              axis_names: tuple[str, str] = ("data", "model"),
              devices: Sequence | None = None) -> Mesh:
    """Build a 2-D (data, model) mesh.

    ``data_parallel=-1`` takes every remaining device.  ``devices`` (any
    ``torch.device`` specs, repeats allowed: a virtual mesh) defaults to
    every visible CUDA card; without CUDA it must be given (``RuntimeError``
    otherwise).  A mesh larger than the devices raises ``ValueError``."""
    if devices is None:
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


@functools.lru_cache(maxsize=1)
def default_mesh() -> Mesh:
    """Every visible CUDA card on the data axis."""
    return make_mesh()


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
    its device.  `gather` (`gather_shards`) is the all-gather."""

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
    first block's): the all-gather of a one-controller mesh."""
    dev = shards[0].device if device is None else torch.device(device)
    return torch.cat([s.to(dev, non_blocking=True) for s in shards], dim=dim)


def shard_leading_axis(mesh: Mesh, tree, axis: str | None = None):
    """Every tensor leaf of ``tree`` split on its leading axis over the
    mesh axis ``axis`` (default: the data axis): each becomes `Shards`,
    block i on device i.  Leading sizes must divide the axis size
    (`pad_to_multiple` first)."""
    devs = mesh.axis_devices(axis)
    return tree_map(lambda x: split_leading(x, devs) if torch.is_tensor(x) else x, tree)


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


def shard_loop(fn, mesh: Mesh, sharded: Sequence, replicated_args=(), *,
               axis: str | None = None, population: int | None = None) -> list:
    """Run ``fn(*sharded_i, *replicated_args)`` on every shard i of
    ``axis``, in mesh order, under `current_shard`; returns the outputs in
    mesh order.  ``sharded`` holds one per-shard sequence per argument
    (`Shards`, or any list of per-device pytrees), ``replicated_args`` go
    to every shard, copied once per distinct device.  ``population`` (the
    rows before padding) sizes each shard's `ShardInfo`; default: the
    shards' total rows.  Nothing is read back: each shard's work is issued
    and the next one's follows."""
    devs = mesh.axis_devices(axis)
    n = len(devs)
    repl = replicate(tuple(replicated_args), devs)
    rows = []
    for i in range(n):
        leaves = [x for x in tree_flatten([s[i] for s in sharded])[0] if torch.is_tensor(x)]
        rows.append(int(leaves[0].shape[0]) if leaves else 0)
    total = sum(rows) if population is None else int(population)
    outs, lo = [], 0
    for i, d in enumerate(devs):
        info = ShardInfo(i, n, d, lo, lo + rows[i], total)
        # a kernel launched through its C entry runs on the current card
        current = torch.cuda.device(d) if d.type == "cuda" else contextlib.nullcontext()
        with _running(info), current:
            outs.append(fn(*(s[i] for s in sharded), *repl[d]))
        lo += rows[i]
    return outs


def gather_tree(outs: Sequence, device, population: int | None = None):
    """The per-shard output pytrees of a shard loop joined along their
    leading axis on ``device``, sliced to ``population`` rows; a leaf that
    is not a tensor (None, a scalar) is shard 0's."""
    flat = [tree_flatten(o) for o in outs]
    spec = flat[0][1]
    joined = []
    for j, leaf in enumerate(flat[0][0]):
        if not torch.is_tensor(leaf) or leaf.ndim == 0:
            joined.append(leaf)
            continue
        x = gather_shards([f[0][j] for f in flat], device)
        joined.append(x if population is None else x[:population])
    return tree_unflatten(joined, spec)


def initialize_distributed(coordinator: str | None = None, num_processes: int | None = None,
                           process_id: int | None = None, *, device=None) -> str:
    """Bring up the ``torch.distributed`` process group (the JAX package's
    `jax.distributed.initialize`).  Without ``coordinator`` the group reads
    ``env://`` (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK); with one
    (``host:port``) it is ``tcp://`` with ``num_processes`` and
    ``process_id``.  The backend is NCCL on the card (``device=None``:
    ``RuntimeError`` without CUDA) and gloo only when the caller asks for
    the CPU.  Returns the backend's name."""
    import torch.distributed as dist

    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if coordinator is None:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id)
    return backend
