"""Batched serving engine over packed-ternary weights.

Weights live on the card at 1.6 bits each (``quantize_for_serving``); the
engine binds each projection's kernel encoding once
(``decode.bind_serving_weights``) and serves requests through the
continuous-batching protocol that
:class:`repro_torch.serving.scheduler.ContinuousScheduler` drives: chunked,
length-bucketed admission into a private single-row cache spliced into the
live batch on the last chunk, and a fused sample → mask → decode step with
stop and budget masking on the device.

:meth:`DecodeEngine.autotune_shapes` measures every eligible kernel at the
engine's decode and admission-chunk shapes, dense and grouped (MoE expert
stacks at their per-expert capacities), so ``policy="auto"`` serving
dispatches on the card's own times.

Prefix caching, speculative decoding, mesh sharding and the generational
``run()`` path are not ported yet; the constructor rejects their arguments.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.dispatch import autotune, get_autotune_cache
from repro_torch.models.config import ModelConfig
from repro_torch.models.decode import (bind_serving_weights, cache_len,
                                       decode_step, init_cache,
                                       layer_grouped_matmul_problems,
                                       layer_matmul_problems,
                                       prefill_chunks_of,
                                       supports_chunked_prefill)
from repro_torch.models.decode import prefill_chunk as model_prefill_chunk


def serving_matmul_problems(cfg: ModelConfig, batch_size: int,
                            seq_len: int = 1
                            ) -> list[tuple[str, int, int, int]]:
    """The dense problems ``(role, M, K, N)`` a serving step of ``cfg``
    dispatches: :func:`layer_matmul_problems` without, on a config whose
    every layer's FFN is the MoE, the dense ``d_ff`` problems ``(M,
    d_model, d_ff)`` and ``(M, d_ff, d_model)``.  Those expert matmuls
    dispatch as grouped problems, so no step dispatches the dense ones
    (the reference's engine lists and times them all the same)."""
    probs = layer_matmul_problems(cfg, batch_size, seq_len)
    if not cfg.n_experts or cfg.moe_every != 1:
        return probs
    M, d, f = batch_size * seq_len, cfg.d_model, cfg.d_ff
    ffn_only = {("wi", M, d, f), ("wo", M, f, d)}
    return [p for p in probs if p not in ffn_only
            or p == ("wo", M, cfg.q_dim, d)]


@dataclass
class SamplerConfig:
    temperature: float = 0.0  # 0 → greedy
    top_k: int = 0
    seed: int = 0
    #: greedy via :func:`greedy_tokens` (bf16-rounded argmax) instead of raw
    #: f32 argmax
    canonical_greedy: bool = False


def greedy_tokens(logits: torch.Tensor) -> torch.Tensor:
    """Canonical greedy selection: round logits to bf16, then argmax; exact
    ties go to the lowest token id."""
    return torch.argmax(logits.to(torch.bfloat16), dim=-1).to(torch.int32)


def sample_tokens(logits: torch.Tensor, cfg: SamplerConfig,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    if cfg.temperature <= 0.0:
        if cfg.canonical_greedy:
            return greedy_tokens(logits)
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits / cfg.temperature
    if cfg.top_k:
        kth = torch.topk(logits, cfg.top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, -1e30, logits)
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[..., 0].to(torch.int32)


#: process-wide monotonic request-id source (see ``Request.rid``)
_RID = itertools.count()


@dataclass
class Request:
    prompt: list[int]
    max_new_tokens: int = 32
    stop_token: int | None = None
    #: streaming callback, fired as ``on_token(request, token)`` per emitted
    #: token (overrides any scheduler-wide callback)
    on_token: Callable[["Request", int], None] | None = None
    out: list[int] = field(default_factory=list)
    done: bool = False
    #: traffic class (grouping key for scheduler statistics)
    tenant: str | None = None
    #: stable monotonically-assigned request id, the key for per-request
    #: bookkeeping (``id(request)`` is reused after garbage collection)
    rid: int = field(default_factory=_RID.__next__)


#: token fed to dead/padding slots (outputs of those rows are never surfaced)
PAD_TOKEN = 1


class DecodeEngine:
    def __init__(self, params, cfg: ModelConfig, *, batch_size: int,
                 max_len: int, sampler: SamplerConfig | None = None,
                 matmul_policy: str | None = None, prefill_chunk: int = 32,
                 device: str | torch.device | None = None, mesh=None,
                 prefix_cache=False, draft=None):
        """Serve ``params`` (the ``quantize_for_serving`` tree) on ``device``
        (default ``cuda``; raises when there is none).

        ``matmul_policy`` overrides ``cfg.matmul_policy`` for every ternary
        projection ("auto" | "prior" | "fixed:<kernel>").  ``prefill_chunk``
        sets the admission chunk (clamped to the ring on windowed configs).
        ``mesh``, ``prefix_cache`` and ``draft`` belong to features not
        ported yet and raise when set."""
        for name, value in (("mesh", mesh), ("prefix_cache", prefix_cache),
                            ("draft", draft)):
            if value is not None and value is not False:
                raise NotImplementedError(
                    f"DecodeEngine({name}=...) is not ported yet: the port "
                    f"serves single-device continuous batching without "
                    f"prefix caching or speculative decoding")
        self.device = resolve_device(device)
        if matmul_policy is not None:
            cfg = cfg.with_(matmul_policy=matmul_policy)
        if not supports_chunked_prefill(params, cfg):
            raise NotImplementedError(
                f"{cfg.name} needs whole-prompt admission, which is not "
                f"ported yet")
        self.cfg = cfg
        self.B = batch_size
        self.batch_size = batch_size  # ScheduleBackend protocol name
        self.max_len = max_len
        self.sampler = sampler or SamplerConfig()
        self.prefill_chunk = max(1, min(prefill_chunk, cache_len(cfg, max_len)))
        params = _to_device(params, self.device)
        self.params = bind_serving_weights(params, cfg)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(self.sampler.seed)

    # ------------------------------------------------------------------
    # kernel autotuning over the engine's shapes
    # ------------------------------------------------------------------

    def _problems(self) -> list[tuple[tuple[int, ...], int | None]]:
        """``(shape, e)`` of every ternary-matmul problem this engine's
        serving path dispatches: dense ``(M, K, N)`` with ``e`` None, grouped
        ``(E, C, K, N)`` with ``e = E``, at decode (``M = B``) and at the
        admission chunk (``M = chunk``; requests are prefilled one at a
        time, chunk by chunk)."""
        probs = set()
        for bs, sl in ((self.B, 1), (1, self.prefill_chunk)):
            probs |= {((m, k, n), None)
                      for _, m, k, n in serving_matmul_problems(self.cfg, bs,
                                                                sl)}
            probs |= {((e, c, k, n), e)
                      for _, e, c, k, n in layer_grouped_matmul_problems(
                          self.cfg, bs, sl)}
        return sorted(probs, key=lambda p: p[0])

    def matmul_shape_universe(self) -> list[tuple[int, ...]]:
        """Every ternary-matmul problem this engine's serving path
        dispatches: dense ``(M, K, N)`` triples at decode (``M = B``) and the
        admission chunk (``M = chunk``), and for MoE configs the grouped
        ``(E, C, K, N)`` quads of the expert stacks at the matching
        per-expert capacities.  The speculative shapes (verify, draft
        decode, draft chunk) come with speculative decoding."""
        return [shape for shape, _ in self._problems()]

    def autotune_shapes(self, **autotune_kw) -> dict:
        """Measure every eligible kernel at each of this engine's shapes,
        dense and grouped (:func:`repro_torch.kernels.dispatch.autotune`, on
        the engine's device), and record the times in the process's
        autotune cache, so ``policy="auto"`` serving dispatches on
        measurements instead of the prior; one cache write at the end.  The
        act dtype is the one dispatch keys on: ``int8`` under
        ``act_dtype="int8"``, else the config's dtype.  Returns ``{shape:
        {kernel: µs}}`` with the shapes of :meth:`matmul_shape_universe`."""
        cache = get_autotune_cache()
        act = "int8" if self.cfg.act_dtype == "int8" else self.cfg.dtype
        results = {}
        for shape, e in self._problems():
            m, k, n = shape[-3:]
            results[shape] = autotune(m, k, n, act, mu=self.cfg.mu,
                                      cache=cache, save=False, e=e,
                                      device=self.device, **autotune_kw)
        cache.save()
        return results

    def run(self, requests: list[Request]) -> list[Request]:
        """Generational batching is not ported yet; use :meth:`serve`."""
        raise NotImplementedError(
            "DecodeEngine.run (generational batching) is not ported yet; "
            "serve() runs the continuous-batching path")

    # ------------------------------------------------------------------
    # continuous batching (ScheduleBackend protocol)
    # ------------------------------------------------------------------

    def sched_start(self) -> dict:
        """Fresh scheduler state: empty cache, all slots dead."""
        B, V, dev = self.B, self.cfg.padded_vocab, self.device
        return {
            "cache": init_cache(self.cfg, B, self.max_len, device=dev),
            "logits": torch.zeros((B, V), dtype=torch.float32, device=dev),
            "live": torch.zeros((B,), dtype=torch.bool, device=dev),
            "index": torch.zeros((B,), dtype=torch.int32, device=dev),
            "remaining": torch.zeros((B,), dtype=torch.int32, device=dev),
            "stop": torch.full((B,), -1, dtype=torch.int32, device=dev),
        }

    def _validate_request(self, request: Request) -> int:
        plen = len(request.prompt)
        if plen < 1:
            raise ValueError("empty prompt")
        if not self.cfg.window and plen + request.max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({plen}) + max_new_tokens ({request.max_new_tokens}) "
                f"exceeds engine max_len {self.max_len}")
        return plen

    def sched_admit_start(self, state: dict, slot: int, request: Request):
        """Begin admitting ``request`` into ``slot``: returns ``(state,
        pending)``; feed ``pending`` to :meth:`sched_admit_step` until it
        returns ``None``.  The prefill runs against a private single-row
        cache, so decode steps on the other rows proceed untouched."""
        plen = self._validate_request(request)
        C, dev = self.prefill_chunk, self.device
        prompt = np.asarray(request.prompt, np.int64)
        chunks = []
        for start, valid in prefill_chunks_of(plen, C):
            toks = np.full((1, C), PAD_TOKEN, np.int64)
            toks[0, :valid] = prompt[start:start + valid]
            pos = np.full((1, C), -1, np.int32)
            pos[0, :valid] = np.arange(start, start + valid)
            chunks.append((torch.from_numpy(toks).to(dev),
                           torch.from_numpy(pos).to(dev), valid - 1))
        pending = {"request": request, "slot": slot, "chunks": chunks, "i": 0,
                   "cache": init_cache(self.cfg, 1, self.max_len, device=dev),
                   "logits1": None}
        return state, pending

    def sched_admit_step(self, state: dict, pending: dict):
        """Prefill one prompt chunk; on the last one splice the row into the
        live state and arm the slot.  Returns ``(state, pending | None)``."""
        toks, pos, take = pending["chunks"][pending["i"]]
        pending["cache"], logits1 = model_prefill_chunk(
            self.params, self.cfg, pending["cache"], toks, pos, take)
        pending["i"] += 1
        if pending["i"] < len(pending["chunks"]):
            return state, pending
        return self._commit(state, pending["slot"], pending["cache"],
                            logits1[0], pending["request"]), None

    def _commit(self, state: dict, slot: int, cache1: dict, logits1,
                request: Request) -> dict:
        """Splice a prefilled single-row cache into batch row ``slot`` and arm
        the slot (in place)."""
        for name in ("k", "v", "pos"):
            state["cache"][name][:, slot] = cache1[name][:, 0]
        state["logits"][slot] = logits1
        state["live"][slot] = True
        state["index"][slot] = len(request.prompt) - 1
        state["remaining"][slot] = request.max_new_tokens
        state["stop"][slot] = -1 if request.stop_token is None \
            else int(request.stop_token)
        return state

    def sched_admit(self, state: dict, slot: int, request: Request) -> dict:
        """Atomic admission: every chunk of ``request`` in one call."""
        state, pending = self.sched_admit_start(state, slot, request)
        while pending is not None:
            state, pending = self.sched_admit_step(state, pending)
        return state

    def sched_step(self, state: dict):
        """Sample → mask dead slots → advance positions → decode → stop and
        budget masking.  Returns ``(state, tokens [B], alive [B])`` as numpy."""
        live = state["live"]
        toks = sample_tokens(state["logits"], self.sampler, self._gen)
        toks = torch.where(live, toks, PAD_TOKEN)
        index = state["index"] + live.to(torch.int32)
        # dead rows decode at -1: their KV/pos writes drop
        logits, cache = decode_step(self.params, self.cfg, state["cache"],
                                    toks, torch.where(live, index, -1))
        remaining = state["remaining"] - live.to(torch.int32)
        alive = live & (toks != state["stop"]) & (remaining > 0)
        state = dict(state, cache=cache, logits=logits, index=index,
                     remaining=remaining, live=alive)
        return state, toks.cpu().numpy(), alive.cpu().numpy()

    def serve(self, requests: list[Request], *,
              on_token: Callable[[Request, int], None] | None = None,
              max_steps: int | None = None,
              admission_budget: int | None = None) -> list[Request]:
        """Run requests through the continuous-batching scheduler; returns
        ``requests`` (same objects, ``out`` filled, in input order)."""
        from repro_torch.serving.scheduler import ContinuousScheduler

        sched = ContinuousScheduler(self, on_token=on_token,
                                    admission_budget=admission_budget)
        for r in requests:
            sched.submit(r)
        sched.run(max_steps=max_steps)
        return requests


def _to_device(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)
