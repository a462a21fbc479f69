"""Optimizers for ternary QAT: AdamW and Adafactor, gradient clipping and
the cosine schedule, after the reference's arithmetic step for step.

A parameter tree is a nested dict of tensors; optimizer states are nested
dicts of f32 tensors beside an int32 step ``count``, in the reference's
layout (``{"m", "v", "count"}``; ``{"s", "count"}`` with ``{"vr", "vc"}``
per matrix, ``{"v"}`` per vector), so a checkpoint of either package
restores in the other.  ``update`` writes the new parameters and state
into the given tensors in place, the port's counterpart of the reference's
donated buffers: peak memory is then the state plus one leaf's
temporaries, not two copies of the state.  With ``ok`` (a 0-d bool
tensor) a step whose ``ok`` is false leaves every tensor as it was, with
no read back to the host.  Large archs (phi3.5-moe, llama4-maverick) train
on Adafactor: factored second moments hold O(rows + cols) a matrix and no
first moment.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import torch

Params = Any


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Params], Any]
    #: ``update(state, grads, params, step, ok=None) -> (params, state)``,
    #: in place (see the module docstring)
    update: Callable[..., tuple[Params, Any]]
    name: str = ""
    #: ``state_specs(param_specs, params) -> specs``: the state's layout on
    #: a mesh from the parameters' (``parallel.sharding.param_specs``)
    state_specs: Callable[[Any, Params], Any] | None = None


def tree_leaves(tree) -> list[torch.Tensor]:
    """Leaves in ``jax.tree_util``'s order: dict keys sorted."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like, leaves):
    """A tree of ``like``'s structure holding ``leaves`` in
    :func:`tree_leaves`' order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    return build(like)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the trees ``rest`` of its
    structure, into a tree of that structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 sum of squares (a 0-d f32
    tensor on the leaves' device)."""
    total = None
    for x in tree_leaves(tree):
        s = torch.sum(torch.square(x.to(torch.float32)))
        total = s if total is None else total + s
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float):
    """``(grads scaled by min(1, max_norm / (norm + 1e-9)), norm)``, each
    leaf scaled in f32 and cast back to its own dtype."""
    n = global_norm(grads)
    scale = torch.clamp_max(max_norm / (n + 1e-9), 1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                    grads), n


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """``lr(step)``: linear warmup over ``warmup`` steps, then a cosine to 0
    at ``total``; an f32 0-d tensor (on ``step``'s device when ``step`` is
    a tensor)."""
    def lr(step):
        if not isinstance(step, torch.Tensor):
            step = torch.tensor(step)
        step = step.to(torch.float32)
        warm = base_lr * torch.clamp_max((step + 1) / max(warmup, 1), 1.0)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        return torch.where(step < warmup, warm,
                           base_lr * 0.5 * (1 + torch.cos(math.pi * t)))
    return lr


def _commit(old: torch.Tensor, new: torch.Tensor, ok) -> None:
    old.copy_(new if ok is None else torch.where(ok, new, old))


def _count(state: dict) -> torch.Tensor:
    return (state["count"] + 1).to(torch.int32)


def adamw(lr_fn, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1) -> Optimizer:
    """AdamW with f32 moments and an f32 update of the (bf16) parameters."""

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        leaf = tree_leaves(params)[0]
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "count": torch.zeros((), dtype=torch.int32,
                                     device=leaf.device)}

    def update(state, grads, params, step, ok=None):
        c = _count(state)
        cf = c.to(torch.float32)
        lr = lr_fn(step).to(cf.device)
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                         device=cf.device), cf)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                         device=cf.device), cf)

        def upd(m, v, g, p):
            g = g.to(torch.float32)
            m_new = b1 * m + (1 - b1) * g
            v_new = b2 * v + (1 - b2) * g * g
            mh = m_new / bc1
            vh = v_new / bc2
            pf = p.to(torch.float32)
            delta = mh / (torch.sqrt(vh) + eps) + weight_decay * pf
            p_new = (pf - lr * delta).to(p.dtype)
            _commit(m, m_new, ok)
            _commit(v, v_new, ok)
            _commit(p, p_new, ok)

        tree_map(upd, state["m"], state["v"], grads, params)
        _commit(state["count"], c, ok)
        return params, state

    def state_specs(param_specs, params):
        """The moments lie as their parameters; the count is whole."""
        return {"m": param_specs, "v": param_specs, "count": ()}

    return Optimizer(init=init, update=update, name="adamw",
                     state_specs=state_specs)


def adafactor(lr_fn, eps=1e-30, clip_threshold=1.0, decay=0.8,
              weight_decay=0.0) -> Optimizer:
    """Adafactor (factored second moments, no first moment): O(rows +
    cols) state for matrices, the exact second moment for vectors."""

    def init(params):
        def st(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if p.ndim >= 2:
                return {"vr": torch.zeros(p.shape[:-1], **f32),
                        "vc": torch.zeros((*p.shape[:-2], p.shape[-1]),
                                          **f32)}
            return {"v": torch.zeros(p.shape, **f32)}
        leaf = tree_leaves(params)[0]
        return {"s": tree_map(st, params),
                "count": torch.zeros((), dtype=torch.int32,
                                     device=leaf.device)}

    def update(state, grads, params, step, ok=None):
        c = _count(state)
        beta = 1.0 - c.to(torch.float32) ** (-decay)
        lr = lr_fn(step).to(c.device)

        def upd(s, g, p):
            g = g.to(torch.float32)
            g2 = g * g + eps
            if p.ndim >= 2:
                vr = beta * s["vr"] + (1 - beta) * g2.mean(-1)
                vc = beta * s["vc"] + (1 - beta) * g2.mean(-2)
                denom = (vr[..., None] / torch.clamp_min(
                    vr.mean(-1)[..., None, None], eps)) * vc[..., None, :]
                u = g * torch.rsqrt(torch.clamp_min(denom, eps))
                _commit(s["vr"], vr, ok)
                _commit(s["vc"], vc, ok)
            else:
                v = beta * s["v"] + (1 - beta) * g2
                u = g * torch.rsqrt(torch.clamp_min(v, eps))
                _commit(s["v"], v, ok)
            rms = torch.sqrt(torch.mean(u * u) + eps)
            u = u / torch.clamp_min(rms / clip_threshold, 1.0)
            pf = p.to(torch.float32)
            _commit(p, (pf - lr * (u + weight_decay * pf)).to(p.dtype), ok)

        # the state's per-leaf dicts sit where params has tensors
        def walk(s, g, p):
            if isinstance(p, dict):
                for k in p:
                    walk(s[k], g[k], p[k])
            else:
                upd(s, g, p)

        walk(state["s"], grads, params)
        _commit(state["count"], c, ok)
        return params, state

    def state_specs(param_specs, params):
        """A matrix's row and column moments keep its spec without the
        last dim and without the second last; a vector's its own."""
        def st(spec, p):
            if isinstance(p, dict):
                return {k: st(spec[k], p[k]) for k in p}
            dims = list(spec) + [None] * (p.ndim - len(spec))
            if p.ndim >= 2:
                return {"vr": tuple(dims[:-1]),
                        "vc": tuple(dims[:-2] + [dims[-1]])}
            return {"v": tuple(dims)}

        return {"s": st(param_specs, params), "count": ()}

    return Optimizer(init=init, update=update, name="adafactor",
                     state_specs=state_specs)


def make_optimizer(name: str, base_lr: float = 3e-4, warmup: int = 100,
                   total: int = 10_000) -> Optimizer:
    lr_fn = cosine_schedule(base_lr, warmup, total)
    if name == "adamw":
        return adamw(lr_fn)
    if name == "adafactor":
        return adafactor(lr_fn)
    raise ValueError(name)
