"""Sharded, atomic, resumable checkpoints in the reference's on-disk
format, so either package restores the other's.

Layout:
  <dir>/step_000123/
      manifest.json        — step, leaf index, shapes/dtypes, checksums
      shard_00000.npz      — flattened leaves (split across shard files)
      _COMMITTED           — written last; restore ignores dirs without it

  * the tree is flattened in ``jax.tree_util``'s order (dict keys sorted);
    each leaf is stored whole, bf16 as its ``uint16`` view with the dtype
    name ``bfloat16`` in the manifest;
  * atomic: the step directory is staged as ``.tmp-step_X`` and renamed
    after the commit marker is written, so a killed writer leaves no
    committed step behind;
  * validated: each leaf's crc32 is recorded and checked on restore;
  * async: :func:`save_async` copies every leaf to the host before it
    returns, then writes on a worker thread (one save in flight at a time).

The shards of one save are written, and read back, by a pool of threads
(one file each): the bytes on disk are those of a serial write.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any

import numpy as np
import torch

from repro_torch.optim.optimizers import tree_leaves, tree_unflatten

_MARKER = "_COMMITTED"
_worker: threading.Thread | None = None
_THREADS = min(8, os.cpu_count() or 1)


class _Host:
    """A leaf on the host: its savable array and dtype name (with ``copy``,
    never sharing the leaf's memory)."""

    def __init__(self, leaf, copy: bool = False):
        if isinstance(leaf, _Host):
            self.array, self.dtype = leaf.array, leaf.dtype
            return
        t = torch.as_tensor(np.asarray(leaf)) \
            if not isinstance(leaf, torch.Tensor) \
            else leaf.detach().to("cpu", copy=copy)
        if t.dtype == torch.bfloat16:
            self.array = t.view(torch.int16).numpy().view(np.uint16)
            self.dtype = "bfloat16"
        else:
            self.array = t.numpy()
            self.dtype = self.array.dtype.name


def _crc32(a: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(a).reshape(-1).view(np.uint8))


def _host_tree(tree):
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    return _Host(tree, copy=True)


def save(path: str, step: int, tree: Any, max_shard_bytes: int = 1 << 30
         ) -> str:
    """Blocking save of a nested dict of tensors.  Returns the committed
    directory."""
    leaves = [_Host(x) for x in tree_leaves(tree)]
    final = os.path.join(path, f"step_{step:08d}")
    tmp = os.path.join(path, f".tmp-step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    manifest = {"step": step, "leaves": [], "shards": []}
    shards: list[dict] = [{}]
    shard_bytes = 0
    for i, h in enumerate(leaves):
        key = f"leaf_{i:06d}"
        manifest["leaves"].append({
            "key": key, "shard": len(shards) - 1, "shape": list(h.array.shape),
            "dtype": h.dtype, "crc32": _crc32(h.array)})
        shards[-1][key] = h.array
        shard_bytes += h.array.nbytes
        if shard_bytes >= max_shard_bytes:
            shards.append({})
            shard_bytes = 0
    shards = [s for s in shards if s]
    manifest["shards"] = [f"shard_{i:05d}.npz" for i in range(len(shards))]

    def write(i):
        np.savez(os.path.join(tmp, manifest["shards"][i]), **shards[i])

    with ThreadPoolExecutor(_THREADS) as pool:
        list(pool.map(write, range(len(shards))))
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, _MARKER), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def save_async(path: str, step: int, tree: Any) -> None:
    """Overlapped save: every leaf copied to the host now (the sync point),
    the disk write on a worker thread."""
    global _worker
    wait()
    host = _host_tree(tree)
    _worker = threading.Thread(target=save, args=(path, step, host),
                               daemon=True)
    _worker.start()


def wait() -> None:
    global _worker
    if _worker is not None:
        _worker.join()
        _worker = None


def latest_step(path: str) -> int | None:
    if not os.path.isdir(path):
        return None
    steps = []
    for d in os.listdir(path):
        if d.startswith("step_") and \
                os.path.exists(os.path.join(path, d, _MARKER)):
            steps.append(int(d.split("_")[1]))
    return max(steps) if steps else None


def _from_saved(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def restore(path: str, step: int, like: Any, *, validate: bool = True) -> Any:
    """Restore into the structure of ``like`` (a nested dict whose leaves
    are tensors, or anything with a ``shape``): each leaf lands on its
    ``like`` leaf's device (the CPU for a meta tensor or a bare shape)."""
    d = os.path.join(path, f"step_{step:08d}")
    if not os.path.exists(os.path.join(d, _MARKER)):
        raise FileNotFoundError(f"no committed checkpoint at {d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)

    def read(fname):
        with np.load(os.path.join(d, fname)) as z:
            return {k: z[k] for k in z.files}

    shards = {}
    with ThreadPoolExecutor(_THREADS) as pool:
        for part in pool.map(read, manifest["shards"]):
            shards.update(part)
    specs = tree_leaves(like)
    if len(specs) != len(manifest["leaves"]):
        raise ValueError(f"{d} holds {len(manifest['leaves'])} leaves, the "
                         f"tree to restore into {len(specs)}")

    def check(i):
        meta = manifest["leaves"][i]
        a = shards[meta["key"]]
        if validate and _crc32(a) != meta["crc32"]:
            raise IOError(f"checksum mismatch for {meta['key']} in {d}")
        if list(a.shape) != list(specs[i].shape):
            raise ValueError(f"shape mismatch {a.shape} vs "
                             f"{tuple(specs[i].shape)} (leaf {i})")
        t = _from_saved(a, meta["dtype"])
        dev = getattr(specs[i], "device", None)
        return t if dev is None or dev.type in ("cpu", "meta") else t.to(dev)

    with ThreadPoolExecutor(_THREADS) as pool:
        out = list(pool.map(check, range(len(specs))))
    return tree_unflatten(like, out)


def restore_latest(path: str, like: Any):
    s = latest_step(path)
    if s is None:
        return None, None
    return s, restore(path, s, like)
