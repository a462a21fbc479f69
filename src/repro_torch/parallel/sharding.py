"""Logical sharding rules: which dims of the parameter, cache, optimizer and
activation trees each mesh axis splits, the reference's name-based rules
rule for rule.

Meshes (``launch/mesh.py``): ``(data, model)`` and ``(pod, data, model)``.

Policy, as the reference's:
  * batch  → ("pod", "data");
  * TP     → "model" on head/FFN/vocab dims, at whole heads and whole
    slice segments only;
  * EP     → an MoE expert dim on "data", TP inside each expert;
  * layer-stack leading axes unsharded;
  * a dim the axis does not divide stays whole (replicated).

A spec is a tuple with one entry per dim: ``None`` (whole), an axis name,
or a tuple of axis names (the dim split over their product, major to
minor), normalized as ``jax.sharding.PartitionSpec`` normalizes its
entries (a one-name tuple is the name, an empty one ``None``), so a spec
here equals ``tuple(P(...))`` of the reference's.

The packed ternary leaves of the in-projections (``wo``, ``down``,
``ffn_down``) shard their dout rows, not their bytes: every rank holds
whole packed rows and computes whole output columns (column-parallel), so
no partial sum is ever reduced and the ranks' slices join by exact
gathers (``parallel/collectives.py``).  Scales are replicated: a rank's
slice keeps the global absmean scale of its matrix.

Trees are nested dicts (a list is indexed as the reference's sequences);
:func:`shard_tree` cuts a rank's slice of a tree from its specs.
"""

from __future__ import annotations

import math
from typing import Any

import torch

#: leaf keys whose last ("out") dim is tensor-parallel
_OUT_MODEL = {"wq", "wk", "wv", "wi", "wg", "up", "wz", "wx", "ffn_up"}
#: leaf keys of the d_model-output ("in") projections: their float "w"
#: leaves shard the contraction (din) dim, their packed leaves the dout
#: rows (column-parallel; see the module docstring)
_IN_MODEL = {"wo", "down", "ffn_down"}
#: out-projections replicated whenever a batch axis coexists with model
#: parallelism (mamba2's gate ``wz``; the reference's partial-replication
#: rule)
_NO_TP_ROLES = {"wz"}

#: public aliases for ``dispatch.ShardInfo``, which localizes a matmul's
#: problem by the same rules
TP_OUT_ROLES = frozenset(_OUT_MODEL)
TP_IN_ROLES = frozenset(_IN_MODEL)

#: projections whose out dim is reshaped to heads and sliced within a head
#: downstream (rope): model-sharded at whole heads only.  Maps the leaf to
#: the ``heads=`` key that gives its head count (wk and wv share kv heads)
_HEAD_ROLES = {"wq": "wq", "wk": "wk", "wv": "wk"}

#: projections whose out dim is sliced at fixed boundaries downstream, and
#: the segment count the slice assumes: xlstm's two-way GLU splits and
#: mamba2's ``wx`` (one segment of the conv concat); sharded only when
#: whole segments land on the ranks
_SPLIT_ROLES = {"ffn_up": 2, "up": 2, "wx": 1}


def _norm(entry):
    """One spec entry as ``PartitionSpec`` keeps it: a one-name tuple is
    the name, an empty tuple ``None``."""
    if isinstance(entry, tuple):
        if not entry:
            return None
        if len(entry) == 1:
            return entry[0]
    return entry


def spec(*entries) -> tuple:
    """A spec: one normalized entry per dim (``P(...)``'s counterpart)."""
    return tuple(_norm(e) for e in entries)


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def batch_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def batch_spec(mesh, extra_dims: int = 1) -> tuple:
    """[B, ...] activations: batch over pod+data, rest replicated."""
    return spec(batch_axes(mesh), *([None] * extra_dims))


def _param_spec(path: tuple[str, ...], ndim: int, mesh,
                tied_embed: bool = False, heads=None) -> tuple:
    names = set(path)
    leaf = path[-1]
    parent = path[-2] if len(path) >= 2 else ""
    has_data = "data" in mesh.axis_names

    def pad(tail: list):
        """Right-align against ndim (stack axes lead, unsharded)."""
        return spec(*([None] * (ndim - len(tail)) + tail))

    def head_safe(role: str) -> bool:
        """Whether model-sharding ``role``'s out dim lands on whole heads
        or segments (and, for ``_NO_TP_ROLES``, on a pure-model mesh)."""
        if role in _NO_TP_ROLES:
            batch = 1
            for a in ("pod", "data"):
                batch *= mesh.shape.get(a, 1)
            return batch == 1
        seg = _SPLIT_ROLES.get(role)
        if seg is not None:
            return seg % mesh.shape["model"] == 0
        key = _HEAD_ROLES.get(role)
        if heads is None or key is None or key not in heads:
            return True
        return heads[key] % mesh.shape["model"] == 0

    # embedding: d_model-sharded, vocab-sharded when tied (the tied head's
    # logits then stay vocab-sharded)
    if "embed" in names:
        if ndim != 2:
            return spec()
        return spec("model", None) if tied_embed else spec(None, "model")
    if "lm_head" in names:
        return spec(None, "model") if ndim == 2 else spec()
    # the router [L?, d_model, E] is not an expert stack: replicated
    if "router" in names:
        return spec()
    # MoE experts: [L?, E, din, dout] (packed [L?, E, dout, din/5]): EP on
    # data, TP inside each expert
    if "moe" in names and ndim >= 3 and leaf in ("w", "packed"):
        ep = "data" if has_data else None
        if leaf == "w":
            tail = ([ep, None, "model"] if parent in ("wi", "wg")
                    else [ep, "model", None])
        else:
            tail = ([ep, "model", None] if parent in ("wi", "wg")
                    else [ep, None, "model"])
        return pad(tail)
    if leaf == "b":  # biases follow their matrix's out dim
        if parent in _OUT_MODEL and head_safe(parent):
            return pad(["model"])
        return spec()
    if leaf == "w":
        if parent in _OUT_MODEL and ndim >= 2 and head_safe(parent):
            return pad([None, "model"])
        if parent in _IN_MODEL and ndim >= 2:
            return pad(["model", None])
        return spec()
    if leaf == "packed":  # [..., dout, din/5]
        if parent in _OUT_MODEL and ndim >= 2 and head_safe(parent):
            return pad(["model", None])
        if parent in _IN_MODEL and ndim >= 2:
            return pad(["model", None])   # column-parallel: whole rows
        return spec()
    # norms, scales, gates, conv, A_log, dt_bias, ... replicated
    return spec()


def _validate(s: tuple, shape, mesh) -> tuple:
    """Drop each axis whose shard count does not divide its dim (that dim
    stays whole); a spec longer than the array's rank raises."""
    if len(s) > len(shape):
        raise ValueError(
            f"spec {s} has {len(s)} axes but the array has rank {len(shape)} "
            f"(shape {tuple(shape)}); sharding rules must not exceed the "
            f"array's rank")
    dims = list(s) + [None] * (len(shape) - len(s))
    out = []
    for size, entry in zip(shape, dims):
        shards = math.prod(mesh.shape[a] for a in _axes(entry))
        out.append(entry if entry is not None and size % shards == 0
                   else None)
    return spec(*out)


def _ndim(x) -> int:
    return getattr(x, "ndim", 0)


def _shape(x) -> tuple:
    return tuple(getattr(x, "shape", ()))


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def param_specs(params: Any, mesh, *, heads=None):
    """A tree of specs mirroring ``params``.  ``heads`` (``{"wq": n_heads,
    "wk": n_kv_heads}``) gates the attention projections to whole heads
    (a head count the model axis does not divide replicates)."""
    tied = isinstance(params, dict) and "embed" in params and \
        "lm_head" not in params
    return _map_with_path(
        lambda path, x: _validate(
            _param_spec(path, _ndim(x), mesh, tied_embed=tied, heads=heads),
            _shape(x), mesh),
        params)


def cache_specs(cache: Any, mesh, *, kv_heads: int | None = None):
    """KV and state caches (``decode.init_cache``'s leaves ``[L, B, ...]``):
    the batch over pod+data; KV on its head_dim, or with ``kv_heads`` given
    (the serving engine's) on whole kv heads; SSM and conv states
    replicated on model; xlstm's states on their head or feature dim."""
    ba = batch_axes(mesh)

    def leaf_spec(path, x):
        nd, leaf = _ndim(x), (path[-1] if path else "")
        if leaf in ("k", "v", "cross_k", "cross_v") and nd == 5:
            s = (spec(None, ba, None, "model", None) if kv_heads is not None
                 else spec(None, ba, None, None, "model"))
        elif leaf == "pos":
            s = spec()
        elif leaf == "ssm" and nd == 5:
            s = spec(None, ba, None, None, None)
        elif leaf == "conv" and nd == 4:
            s = spec(None, ba, None, None)
        elif leaf == "mC" and nd == 5:
            s = spec(None, ba, None, "model", None)
        elif leaf == "mn" and nd == 4:
            s = spec(None, ba, None, "model")
        elif leaf == "mm" and nd == 3:
            s = spec(None, ba, None)
        elif leaf in ("sc", "sn", "sh", "sm") and nd == 3:
            s = spec(None, ba, "model")
        elif nd >= 2:
            s = spec(None, ba)
        else:
            s = spec()
        return _validate(s, _shape(x), mesh)

    return _map_with_path(leaf_spec, cache)


def block_slab_specs(slab: Any, mesh, *, kv_heads: int | None = None):
    """Prefix-cache KV slabs ``{"k", "v": [L, C, Hkv, hd]}``: the cache's
    kv-head rule without its batch dim."""
    def leaf_spec(x):
        if _ndim(x) == 4:
            s = (spec(None, None, "model", None) if kv_heads is not None
                 else spec(None, None, None, "model"))
        else:
            s = spec()
        return _validate(s, _shape(x), mesh)

    return _map(leaf_spec, slab)


def batch_specs(batch: Any, mesh):
    """Input batches: dim 0 over pod+data where it divides."""
    ba = batch_axes(mesh)

    def leaf_spec(x):
        nd = _ndim(x)
        if nd == 0:
            return spec()
        return _validate(spec(ba, *([None] * (nd - 1))), _shape(x), mesh)

    return _map(leaf_spec, batch)


def engine_state_specs(state: Any, mesh, *, kv_heads: int | None = None):
    """The serving scheduler's state (``DecodeEngine.sched_start``): the
    cache through :func:`cache_specs`, every per-slot control vector on
    the batch where it divides, a draft's cache (``dcache``) replicated."""
    control = {k: v for k, v in state.items()
               if k not in ("cache", "dcache")}
    specs = batch_specs(control, mesh)
    specs["cache"] = cache_specs(state["cache"], mesh, kv_heads=kv_heads)
    if "dcache" in state:
        specs["dcache"] = _map(lambda _: spec(), state["dcache"])
    return specs


# ---------------------------------------------------------------------------
# a rank's slice
# ---------------------------------------------------------------------------


def shard_count(s: tuple, mesh) -> int:
    """Into how many pieces ``s`` cuts a leaf."""
    return math.prod(mesh.shape[a] for e in s for a in _axes(e))


def local_shape(shape, s: tuple, mesh) -> tuple[int, ...]:
    """A rank's shape of a leaf of ``shape`` under the spec ``s``."""
    dims = list(s) + [None] * (len(shape) - len(s))
    return tuple(size // math.prod(mesh.shape[a] for a in _axes(e))
                 for size, e in zip(shape, dims))


def local_shard(x: torch.Tensor, s: tuple, mesh) -> torch.Tensor:
    """This rank's contiguous slice of ``x`` under the spec ``s``: along
    each split dim the piece at the rank's coordinate (the axes of an
    entry major to minor).  A split leaf is copied, so the whole leaf can
    be freed; a whole one is returned as is."""
    if shard_count(s, mesh) == 1:
        return x
    for dim, e in enumerate(s):
        axes = _axes(e)
        if not axes:
            continue
        n = math.prod(mesh.shape[a] for a in axes)
        idx = mesh.index(axes)
        size = x.shape[dim] // n
        x = x.narrow(dim, idx * size, size)
    return x.clone()


def shard_tree(tree: Any, specs: Any, mesh):
    """Each leaf's :func:`local_shard` under its spec in ``specs``."""
    return _map(lambda x, s: local_shard(x, s, mesh)
                if isinstance(x, torch.Tensor) else x, tree, specs)


def sharded_bytes(tree: Any, specs: Any, mesh) -> float:
    """Per-device bytes of ``tree`` laid out by ``specs``: each leaf's
    bytes over its shard count (the reference dry run's
    ``_sharded_bytes``)."""
    total = 0.0

    def add(x, s):
        nonlocal total
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size() / shard_count(s, mesh)
        return x

    _map(add, tree, specs)
    return total
