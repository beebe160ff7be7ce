"""Checkpoints of a model's parameters: one atomic directory write.

Port of `ai_crypto_trader_tpu/utils/checkpoint.py` for the port's flat
parameter sets ({name: tensor}, as a `TrainResult` holds them): the
tensors go into one ``tensors.npz`` under their names and the metadata
into ``meta.json``.  The tree is flat, so no tree structure is pickled.
The directory is written beside the target and swapped in, so at every
instant a complete checkpoint exists at ``path`` or ``path + '.old'``.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from ai_crypto_trader_tpu_torch.device import resolve_device


def save_checkpoint(path: str, params: dict | None = None, metadata: dict | None = None,
                    *, tree: dict | None = None) -> str:
    """Atomically save ``params`` ({name: tensor}) and JSON ``metadata`` to
    ``path`` (a directory); returns its absolute path.  The parameter set
    may also be passed as ``tree=``, the JAX package's name for it (its
    second argument is a pytree); pass one of the two."""
    if (params is None) == (tree is None):
        raise TypeError("save_checkpoint takes the parameters once: params or tree")
    params = tree if params is None else params
    path = os.path.abspath(path)
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays = {k: v.detach().cpu().numpy() for k, v in params.items()}
    with open(os.path.join(tmp, "tensors.npz"), "wb") as f:
        np.savez(f, **arrays)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"names": list(arrays), "metadata": metadata or {}}, f, indent=2)

    old = path + ".old"
    if os.path.exists(old):
        shutil.rmtree(old)
    if os.path.exists(path):
        os.replace(path, old)
    os.replace(tmp, path)
    if os.path.exists(old):
        shutil.rmtree(old)
    return path


def load_checkpoint(path: str, device=None):
    """(params {name: tensor} on ``device`` (None: the CUDA card), in the
    saved order; metadata)."""
    dev = resolve_device(device)
    path = os.path.abspath(path)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(path, "tensors.npz")) as data:
        params = {k: torch.from_numpy(data[k]).to(dev) for k in meta["names"]}
    return params, meta["metadata"]
