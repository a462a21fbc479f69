"""The rank side of ``tests/test_torch_sharding.py``: what each spawned
rank of a CPU gloo mesh runs.  It imports torch and the port only (the
ranks start from a fresh interpreter, and JAX would add seconds to each)."""

from __future__ import annotations

import numpy as np
import torch


def serve_on_mesh(mesh, device, models, prompts, new_tokens: int,
                  batch: int, max_len: int, chunk: int) -> dict:
    """:func:`gathers`, then for each ``(tree, cfg)`` of ``models`` (the
    whole serving tree) the sharded engine: its streams by canonical
    greedy, the admission logits of ``prompts[0]``, the rank's local shape
    universe, cache shape and collectives."""
    from repro_torch.serving.engine import (DecodeEngine, Request,
                                            SamplerConfig)

    torch.set_num_threads(1)
    out = {"gathers": gathers(mesh, device, 3), "models": []}
    for tree, cfg in models:
        mesh.stats.reset()
        eng = DecodeEngine(tree, cfg, batch_size=batch, max_len=max_len,
                           prefill_chunk=chunk, device=device, mesh=mesh,
                           sampler=SamplerConfig(canonical_greedy=True))
        reqs = [Request(prompt=list(p), max_new_tokens=new_tokens)
                for p in prompts]
        eng.serve(reqs)
        # the generational run() on the first prompts, one batch
        gen = [Request(prompt=list(p), max_new_tokens=new_tokens)
               for p in prompts[:batch]]
        eng.run(gen)
        # one more admission of the first prompt: its last position's logits
        state = eng.sched_admit(eng.sched_start(), 0,
                                Request(prompt=list(prompts[0])))
        out["models"].append({"streams": [r.out for r in reqs],
                              "run_streams": [r.out for r in gen],
                    "logits": state["logits"][0].numpy(),
                    "universe": eng.matmul_shape_universe(),
                    "cache_shape": tuple(state["cache"]["k"].shape),
                    "stats": mesh.stats.as_dict()})
    return out


def gathers(mesh, device, seed: int) -> dict:
    """Each collective on this rank's slice of a seeded tensor: the joined
    tensors as the ranks see them."""
    from repro_torch.parallel import collectives as col

    g = torch.Generator().manual_seed(seed)
    whole = torch.randn((6, mesh.shape["model"] * 4), generator=g).to(
        torch.bfloat16)
    whole[0, 0] = -0.0
    m = mesh.coord("model")
    mine = whole[:, m * 4:(m + 1) * 4]
    rows = torch.arange(mesh.size_of(mesh.batch_axes) * 2 * 3,
                        dtype=torch.float32).reshape(-1, 3)
    b = mesh.index(mesh.batch_axes)
    disjoint = torch.where(torch.arange(6)[:, None] % mesh.shape["model"]
                           == m, whole[:, :4], torch.zeros((),
                                                           dtype=whole.dtype))
    with col.mesh_scope(mesh):
        out = {"last": col.gather_last(mine).view(torch.int16).numpy(),
               "want_last": whole.view(torch.int16).numpy(),
               "batch": col.gather_batch(rows[2 * b:2 * b + 2], mesh).numpy(),
               "want_batch": rows.numpy(),
               "disjoint": col.sum_disjoint(disjoint).view(
                   torch.int16).numpy(),
               "want_disjoint": whole[:, :4].view(torch.int16).numpy(),
               "stats": mesh.stats.as_dict()}
    return {k: np.asarray(v) if isinstance(v, np.ndarray) else v
            for k, v in out.items()}
