"""Persistent kernel-build cache: a restart loads the kernels it built before.

Port of `ai_crypto_trader_tpu/utils/aotcache.py`.  The JAX module keys
XLA's persistent compilation cache by build provenance.  The port's
compiled artifacts are the nvcc libraries of `ops._cuda` (one shared
library per ``csrc/*.cu``), so this module keys THEIR directory: `enable`
points `ops._cuda`'s build directory at
``<path>/<sha256(torch version, CUDA version, device name, NVCC_FLAGS)[:16]>``
and, for a CUDA system, builds every library there at once (one nvcc per
source, run together).  A warm restart finds them all built: it compiles
nothing and counts them as ``cache_hits``.

Three disciplines, as in the JAX module:

  * **Provenance keying**: a library built by one toolchain for one card
    is not loaded by another.  A torch, CUDA, card or flag change lands
    in a FRESH directory; a stale library is unreachable rather than
    detected-and-handled.  (Each library's own name already hashes its
    source and flags, so an edited source rebuilds in the same directory.)
  * **Single pruner**: an advisory ``flock`` on a long-lived fd (released
    by the kernel when the owner dies) guards pruning.  A library is
    written to a temporary file and renamed into place (`ops._cuda.build`),
    so a reader never sees a torn one: a second process that cannot take
    the lock shares the directory (``lock: "shared"``) and prunes nothing.
  * **Fallback = build in the default directory, never crash, never hide a
    kernel**: every failure mode here (an unwritable directory, a
    failed prebuild) leaves ``ops._cuda`` on its default
    directory and is recorded on ``status()``; the kernels then build
    there at their first use, exactly as without this module.  A library
    this process loaded before `enable` stays loaded from where it was
    and is not built into the cache (``loaded_before`` names it).

The directory is size-bounded: `enable` prunes oldest-mtime entries past
``max_bytes`` while holding the lock.  ``build`` is injectable (a
test without nvcc hands in a stub that writes the library files).
"""

from __future__ import annotations

import hashlib
import json
import os
import time

#: default directory size bound — two libraries are a few MB; 512 MB
#: absorbs years of toolchain drift before pruning matters
DEFAULT_MAX_BYTES = 512 * 1024 * 1024

#: bookkeeping files that are never cache entries (and never pruned)
_META_FILES = (".writer.pid", "meta.json")


def _dir_entries(path: str) -> list[tuple[str, float, int]]:
    """(file, mtime, bytes) for every cache entry under ``path`` —
    bookkeeping files excluded."""
    out = []
    try:
        names = os.listdir(path)
    except OSError:
        return out
    for name in names:
        if name in _META_FILES:
            continue
        fp = os.path.join(path, name)
        try:
            st = os.stat(fp)
        except OSError:
            continue
        if os.path.isfile(fp):
            out.append((fp, st.st_mtime, st.st_size))
    return out


def prune_dir(path: str, max_bytes: int) -> int:
    """Delete oldest-mtime cache entries until the directory fits in
    ``max_bytes``; returns the number of files removed.  Callers hold the
    writer lock."""
    entries = _dir_entries(path)
    total = sum(size for _, _, size in entries)
    if total <= max_bytes:
        return 0
    removed = 0
    for fp, _, size in sorted(entries, key=lambda e: e[1]):
        if total <= max_bytes:
            break
        try:
            os.remove(fp)
            total -= size
            removed += 1
        except OSError:
            continue
    return removed


def build_coordinates(build_info: dict | None = None) -> dict:
    """The coordinates a library's compatibility depends on: torch and CUDA
    versions, the card's name, nvcc's flags.  Missing ones are read from
    the running process, so a bare child process keys as the launcher
    that filled the cache."""
    import torch

    from ai_crypto_trader_tpu_torch.ops import _cuda

    info = build_info or {}
    kind = info.get("device_kind")
    if not kind:
        kind = (torch.cuda.get_device_name(0) if torch.cuda.is_available()
                else "cpu")
    return {"torch_version": info.get("torch_version") or torch.__version__,
            "cuda_version": info.get("cuda_version") or torch.version.cuda,
            "device_kind": kind,
            "nvcc_flags": " ".join(_cuda.NVCC_FLAGS)}


def provenance_key(build_info: dict | None = None) -> str:
    """Cache-directory key over `build_coordinates`."""
    blob = json.dumps(build_coordinates(build_info), sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


class AOTCache:
    """One process's handle on the persistent kernel-build cache.

    `enable()` (call BEFORE the first kernel use) points the kernel build
    at the provenance-keyed subdirectory under the writer lock and, for a
    CUDA system, builds the libraries there; `status()` is the
    /state.json block; `close()` releases the lock and restores the
    default directory.  Every failure is recorded, none is raised."""

    def __init__(self, path: str, *, max_bytes: int = DEFAULT_MAX_BYTES,
                 build=None):
        self.path = str(path)
        self.max_bytes = int(max_bytes)
        self._build = build
        self.enabled = False
        self.active_dir: str | None = None
        self.key: str | None = None
        self.warm = False                 # entries existed at enable time
        self.entries_at_enable = 0
        self.bytes_at_enable = 0
        self.pruned_files = 0
        self.built: list[str] = []        # libraries compiled by enable()
        self.cache_hits = 0               # libraries enable() found built
        self.build_s = 0.0
        self.loaded_before: list[str] = []
        self.lock: str | None = None      # "held" or "shared"
        self.error: str | None = None
        self._lock_fh = None
        self._prev_dir = None

    # -- lifecycle -----------------------------------------------------------
    def enable(self, build_info: dict | None = None,
               prebuild: bool | None = None) -> bool:
        """Activate the cache: resolve the provenance directory, take the
        writer lock, prune past the size bound, point the kernel build
        there, and (``prebuild``; default: a CUDA backend in
        ``build_info``) build in it every library this process has not
        loaded yet.  False (with ``error``
        set) means the kernels build in the default directory."""
        import fcntl

        from ai_crypto_trader_tpu_torch.ops import _cuda

        if prebuild is None:
            prebuild = (build_info or {}).get("backend") == "cuda"
        try:
            self.key = provenance_key(build_info)
            active = os.path.join(self.path, self.key)
            os.makedirs(active, exist_ok=True)
            fh = open(os.path.join(active, ".writer.pid"), "a+")
            try:
                fcntl.flock(fh, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError:
                fh.close()
                self.lock = "shared"      # another process prunes
            else:
                fh.seek(0)
                fh.truncate()
                fh.write(str(os.getpid()))
                fh.flush()
                self._lock_fh = fh        # fd lifetime IS the lock lifetime
                self.lock = "held"
                self.pruned_files = prune_dir(active, self.max_bytes)
            entries = _dir_entries(active)
            self.entries_at_enable = len(entries)
            self.bytes_at_enable = sum(size for _, _, size in entries)
            self.warm = self.entries_at_enable > 0
            self.loaded_before = _cuda.loaded()
            self._prev_dir = _cuda.set_build_dir(active)
            self.active_dir = active
            missing = [n for n in _cuda.SOURCES if n not in self.loaded_before]
            if prebuild and missing:
                t0 = time.perf_counter()
                report = (self._build or _cuda.build)(missing)
                self.build_s = time.perf_counter() - t0
                self.built = sorted(n for n, r in report.items()
                                    if not r["cached"])
                self.cache_hits = sum(1 for r in report.values() if r["cached"])
            if self.lock == "held":
                with open(os.path.join(active, "meta.json"), "w") as f:
                    json.dump({"key": self.key, "pid": os.getpid(),
                               "t": time.time(),
                               "coordinates": build_coordinates(build_info)}, f)
            self.enabled = True
            return True
        except Exception as exc:          # noqa: BLE001 — never crash
            self.error = f"{type(exc).__name__}: {exc}"[:500]
            self._restore()
            self.active_dir = None
            self._release()
            return False

    def _restore(self) -> None:
        if self._prev_dir is not None:
            from ai_crypto_trader_tpu_torch.ops import _cuda

            _cuda.set_build_dir(self._prev_dir)
            self._prev_dir = None

    def _release(self) -> None:
        if self._lock_fh is not None:
            try:
                self._lock_fh.close()
            finally:
                self._lock_fh = None

    def close(self) -> None:
        """Release the writer lock and point later builds back at the
        default directory (shutdown seam).  The pidfile stays as a
        breadcrumb."""
        self._restore()
        self._release()

    # -- views ---------------------------------------------------------------
    def status(self) -> dict:
        """The /state.json ``aot_cache`` block: where the cache points,
        whether this restart was warm, what it built, and why it is off
        when it is off."""
        entries = (_dir_entries(self.active_dir)
                   if self.active_dir else [])
        return {
            "enabled": self.enabled,
            "dir": self.active_dir,
            "key": self.key,
            "warm": self.warm,
            "entries_at_enable": self.entries_at_enable,
            "bytes_at_enable": self.bytes_at_enable,
            "entries": len(entries),
            "bytes": sum(size for _, _, size in entries),
            "pruned_files": self.pruned_files,
            "max_bytes": self.max_bytes,
            "lock": self.lock,
            "built": list(self.built),
            "cache_hits": self.cache_hits,
            "build_s": self.build_s,
            "loaded_before": list(self.loaded_before),
            "error": self.error,
        }
