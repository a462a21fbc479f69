"""Batched serving engine over packed-ternary weights.

Weights live on the card at 1.6 bits each (``quantize_for_serving``); the
engine binds each projection's kernel encoding once
(``decode.bind_serving_weights``) and serves requests through the
continuous-batching protocol that
:class:`repro_torch.serving.scheduler.ContinuousScheduler` drives: chunked,
length-bucketed admission into a private single-row cache spliced into the
live batch on the last chunk, and a fused sample → mask → decode step with
stop and budget masking on the device.  Architectures the chunked path
does not cover (zamba2's and xlstm's recurrent states, whisper's encoder,
internvl2's vision prefix) admit whole: one single-row ``prefill`` of the
prompt, committed through the same splice; the modality frontends get the
reference engine's stand-in inputs (zero frame or vision embeddings).
:meth:`DecodeEngine.run` is the generational baseline: one batched prefill
of left-padded prompts, the batch turning over at the pace of its slowest
request.

:meth:`DecodeEngine.autotune_shapes` measures every eligible kernel at the
engine's decode and admission-chunk shapes, dense and grouped (MoE expert
stacks at their per-expert capacities), so ``policy="auto"`` serving
dispatches on the card's own times.

With ``prefix_cache`` set, admission consults a hashed shared-prefix KV
block store (:class:`repro_torch.serving.prefix_cache.PrefixBlockStore`):
the longest run of cached blocks is spliced into the private cache instead
of recomputed, each freshly computed full block is published, and
:meth:`DecodeEngine.prefix_match_len` lets the scheduler admit cache-hot
requests first.

With ``draft=(params, cfg)`` the engine decodes speculatively: each
scheduler step is one round in which the draft proposes ``spec_k - 1``
greedy continuations of the target's free next token, the target scores
all ``spec_k`` candidates in one batched :func:`~repro_torch.models.decode.
verify_step`, the accepted prefix is kept and the rest is rolled back on
both KV rings (:func:`~repro_torch.models.decode.rollback_kv_window`).
Every emitted token is the target's own canonical greedy choice.

Mesh sharding is not ported yet; the constructor rejects ``mesh``.
"""

from __future__ import annotations

import itertools
import logging
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.dispatch import autotune, get_autotune_cache
from repro_torch.models.config import ModelConfig
from repro_torch.models.decode import (bind_serving_weights, cache_len,
                                       check_prompt_len, decode_step,
                                       extract_kv_blocks, init_cache,
                                       layer_grouped_matmul_problems,
                                       layer_matmul_problems, prefill,
                                       prefill_chunks_of, prefill_into_slot,
                                       rollback_kv_window,
                                       snapshot_kv_window, splice_kv_blocks,
                                       splice_rows, supports_chunked_prefill,
                                       verify_step)
from repro_torch.models.decode import prefill_chunk as model_prefill_chunk
from repro_torch.models.model import check_supported
from repro_torch.serving.prefix_cache import PrefixBlockStore

logger = logging.getLogger(__name__)


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
                 prefix_cache=False, prefix_cache_mb: float = 64.0,
                 draft=None, spec_k: int = 4):
        """Serve ``params`` (the ``quantize_for_serving`` tree) on ``device``
        (default ``cuda``; raises when there is none).

        ``matmul_policy`` overrides ``cfg.matmul_policy`` for every ternary
        projection ("auto" | "prior" | "fixed:<kernel>").  ``prefill_chunk``
        sets the admission chunk (clamped to the ring on windowed configs).

        Configs without chunked prefill (``supports_chunked_prefill``:
        zamba2, xlstm) admit each request whole (``chunked_admission`` is
        False).

        ``prefix_cache`` turns on hashed shared-prefix KV reuse: pass True
        (a fresh :class:`PrefixBlockStore` with a ``prefix_cache_mb`` byte
        budget) or a store instance to share across engines of the same
        geometry; on a whole-prompt architecture it logs a warning and
        stays off.  Admission then consults the store per prompt block (block
        = one ``prefill_chunk``), splices cached KV slabs instead of
        recomputing hit blocks, and publishes each freshly computed full
        block; on windowed configs reuse depth is capped at the ring length.
        The slabs are device memory beside the KV cache, counted against
        the budget.

        ``draft = (draft_params, draft_cfg)`` (a ``quantize_for_serving``
        tree and its config) turns on draft-and-verify speculative decoding
        with ``spec_k`` candidates a round (the target's free next token
        plus ``spec_k - 1`` drafted; see the module docstring).  Greedy
        only; draft and target must share the vocabulary and both take the
        chunked path; admission prefills the draft's own ring beside the
        target's.  ``matmul_policy`` governs the draft too.

        ``mesh`` (sharded serving) is not ported yet and raises when set,
        with or without a draft."""
        if mesh is not None:
            raise NotImplementedError(
                "DecodeEngine(mesh=...) is not ported yet: the port serves "
                "on a single device, without mesh sharding")
        self.device = resolve_device(device)
        if matmul_policy is not None:
            cfg = cfg.with_(matmul_policy=matmul_policy)
        #: speculative decoding: 0 = off, else candidates a verify scores
        self.spec_k = 0
        self.draft_cfg: ModelConfig | None = None
        self.draft_params = None
        if draft is not None:
            draft_params, draft_cfg = draft
            if matmul_policy is not None:
                draft_cfg = draft_cfg.with_(matmul_policy=matmul_policy)
            self._check_draft(params, cfg, draft_params, draft_cfg, max_len,
                              sampler or SamplerConfig(), spec_k)
            self.spec_k = spec_k
            self.draft_cfg = draft_cfg
        check_supported(cfg)
        #: False: each request admits through one whole-prompt prefill
        self.chunked_admission = supports_chunked_prefill(params, cfg)
        self.cfg = cfg
        self.B = batch_size
        self.batch_size = batch_size  # ScheduleBackend protocol name
        self.max_len = max_len
        self.sampler = sampler or SamplerConfig()
        self._CL = cache_len(cfg, max_len)
        self.prefill_chunk = max(1, min(prefill_chunk, self._CL))
        self.prefix_store = self._make_prefix_store(prefix_cache,
                                                    prefix_cache_mb)
        params = _to_device(params, self.device)
        self.params = bind_serving_weights(params, cfg)
        if self.spec_k:
            self.draft_params = bind_serving_weights(
                _to_device(draft[0], self.device), self.draft_cfg)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(self.sampler.seed)

    @staticmethod
    def _check_draft(params, cfg: ModelConfig, draft_params,
                     draft_cfg: ModelConfig, max_len: int,
                     sampler: SamplerConfig, spec_k: int) -> None:
        """The reference's refusals of a draft, with its exception types."""
        if draft_cfg.vocab_size != cfg.vocab_size:
            raise ValueError(
                f"draft/target tokenizer mismatch: draft {draft_cfg.name} has "
                f"vocab_size {draft_cfg.vocab_size} but target {cfg.name} has "
                f"{cfg.vocab_size}; speculative decoding compares token ids "
                f"directly, so draft and target must share one vocabulary")
        if sampler.temperature > 0.0:
            raise ValueError(
                f"speculative decoding preserves greedy streams only "
                f"(temperature=0); got temperature={sampler.temperature}")
        if spec_k < 2:
            raise ValueError(
                f"spec_k must be >= 2 (the target's free next token plus at "
                f"least one drafted candidate); got {spec_k}")
        for side, c in (("target", cfg), ("draft", draft_cfg)):
            if spec_k > cache_len(c, max_len):
                raise ValueError(
                    f"spec_k {spec_k} exceeds the {side} ring length "
                    f"{cache_len(c, max_len)}: one verify window would "
                    f"collide with itself in the KV ring")
        for side, pp, c in (("target", params, cfg),
                            ("draft", draft_params, draft_cfg)):
            if not supports_chunked_prefill(pp, c):
                raise ValueError(
                    f"speculative decoding needs the batched verify forward "
                    f"(the chunked-prefill path), which the {side} "
                    f"architecture {c.name} does not support "
                    f"(block_pattern={c.block_pattern})")

    def _make_prefix_store(self, prefix_cache, prefix_cache_mb: float):
        """Resolve the ``prefix_cache`` argument into a
        :class:`PrefixBlockStore` (or None).  The store's hash namespace
        binds the KV-producing geometry (config name, depth, kv-head shape;
        the JAX package's string, byte for byte), so slabs can never be
        replayed across engines whose caches they would not fit."""
        # identity checks, not truthiness: an EMPTY store instance is falsy
        # (len() == 0) but must still be wired in and validated
        if prefix_cache is None or prefix_cache is False:
            return None
        if not self.chunked_admission:
            logger.warning(
                "prefix cache requested but %s admits through whole-prompt "
                "fallback (no chunked prefill); prefix reuse disabled",
                self.cfg.name)
            return None
        c = self.cfg
        ns = (f"{c.name}:{c.n_layers}:{c.n_kv_heads}:{c.head_dim}:"
              f"{c.d_model}").encode()
        if prefix_cache is True:
            return PrefixBlockStore(
                self.prefill_chunk,
                max_bytes=max(1, int(prefix_cache_mb * (1 << 20))),
                namespace=ns)
        store = prefix_cache
        if store.block_tokens != self.prefill_chunk:
            raise ValueError(
                f"prefix store block size {store.block_tokens} != engine "
                f"prefill_chunk {self.prefill_chunk}: blocks are admission "
                f"chunks, the sizes must agree")
        if store.namespace != ns:
            raise ValueError(
                "prefix store namespace mismatch: the store was built for a "
                "different model geometry; sharing it would splice foreign "
                "KV slabs")
        return store

    # ------------------------------------------------------------------
    # kernel autotuning over the engine's shapes
    # ------------------------------------------------------------------

    def _shape_sources(self) -> list[tuple[ModelConfig, int, int]]:
        """``(cfg, batch_size, seq_len)`` of every forward the serving path
        runs: the target's decode (``B`` rows) and admission chunk (one
        request at a time, chunk by chunk), and with a draft the target's
        verify (``B · spec_k`` rows), the draft's decode and its admission
        chunk."""
        sources = [(self.cfg, self.B, 1), (self.cfg, 1, self.prefill_chunk)]
        if self.spec_k:
            sources += [(self.cfg, self.B, self.spec_k),
                        (self.draft_cfg, self.B, 1),
                        (self.draft_cfg, 1, self.prefill_chunk)]
        return sources

    @staticmethod
    def _problems(cfg: ModelConfig, bs: int, sl: int
                  ) -> set[tuple[tuple[int, ...], int | None]]:
        """``(shape, e)`` of every ternary-matmul problem one forward of
        ``cfg`` over ``bs`` rows of ``sl`` tokens dispatches: dense ``(M, K,
        N)`` with ``e`` None, grouped ``(E, C, K, N)`` with ``e = E``."""
        return ({((m, k, n), None)
                 for _, m, k, n in serving_matmul_problems(cfg, bs, sl)}
                | {((e, c, k, n), e)
                   for _, e, c, k, n in layer_grouped_matmul_problems(
                       cfg, bs, sl)})

    def matmul_shape_universe(self) -> list[tuple[int, ...]]:
        """Every ternary-matmul problem this engine's serving path
        dispatches (:meth:`_shape_sources`): dense ``(M, K, N)`` triples
        and, for MoE configs, the grouped ``(E, C, K, N)`` quads of the
        expert stacks at the matching per-expert capacities."""
        return sorted({shape for src in self._shape_sources()
                       for shape, _ in self._problems(*src)})

    def autotune_shapes(self, **autotune_kw) -> dict:
        """Measure every eligible kernel at each of this engine's shapes,
        dense and grouped (:func:`repro_torch.kernels.dispatch.autotune`, on
        the engine's device), and record the times in the process's
        autotune cache, so ``policy="auto"`` serving dispatches on
        measurements instead of the prior; one cache write at the end.
        Each source is timed at the act dtype its config dispatches on
        (``int8`` under ``act_dtype="int8"``, else the config's dtype), so
        a draft's problems are timed as the draft runs them.  Returns
        ``{shape: {kernel: µs}}`` with the shapes of
        :meth:`matmul_shape_universe`."""
        cache = get_autotune_cache()
        results, seen = {}, set()
        for c, bs, sl in self._shape_sources():
            act = "int8" if c.act_dtype == "int8" else c.dtype
            for shape, e in sorted(self._problems(c, bs, sl),
                                   key=lambda p: p[0]):
                if (shape, act) in seen:
                    continue
                seen.add((shape, act))
                m, k, n = shape[-3:]
                results[shape] = autotune(m, k, n, act, mu=c.mu, cache=cache,
                                          save=False, e=e, device=self.device,
                                          **autotune_kw)
        cache.save()
        return results

    def run(self, requests: list[Request]) -> list[Request]:
        """Run a batch of at most ``batch_size`` requests to completion
        (generational batching): the prompts, left-padded with
        ``PAD_TOKEN`` to the longest, prefill in one batched ``prefill``,
        every row then decodes at one shared position, and the batch turns
        over at the pace of its slowest request.  Use :meth:`serve` for
        continuous batching.  Returns ``requests``."""
        if len(requests) > self.B:
            raise ValueError(
                f"got {len(requests)} requests for batch_size {self.B}; "
                "generational run() cannot queue — use serve() instead")
        reqs = list(requests) + [Request(prompt=[PAD_TOKEN], max_new_tokens=0)
                                 for _ in range(self.B - len(requests))]
        plen = max(len(r.prompt) for r in reqs)
        max_new = max(r.max_new_tokens for r in reqs)
        if not self.cfg.window and plen + max_new > self.max_len:
            # out-of-range positions would silently drop their KV writes
            raise ValueError(
                f"prompt ({plen}) + max_new_tokens ({max_new}) exceeds "
                f"engine max_len {self.max_len}")
        toks = np.full((self.B, plen), PAD_TOKEN, np.int64)
        for i, r in enumerate(reqs):
            toks[i, plen - len(r.prompt):] = r.prompt  # left-pad
        # a VLM's vision prefix overwrites the first positions of the
        # left-padded batch, so its length rule holds for the padded length
        cache, logits = prefill(self.params, self.cfg,
                                {"tokens": torch.from_numpy(toks).to(
                                    self.device),
                                 **self._stub_inputs(self.B)},
                                s_max=self.max_len)
        cur = plen - 1
        for t in range(max_new):
            tokens = sample_tokens(logits, self.sampler, self._gen)
            arr = tokens.cpu().numpy()
            for i, r in enumerate(reqs):
                if r.done or t >= r.max_new_tokens:
                    continue
                tok = int(arr[i])
                r.out.append(tok)
                if r.on_token is not None:
                    r.on_token(r, tok)
                if r.stop_token is not None and tok == r.stop_token:
                    r.done = True
            if all(r.done or len(r.out) >= r.max_new_tokens for r in reqs):
                break
            cur += 1
            logits, cache = decode_step(self.params, self.cfg, cache, tokens,
                                        cur)
        for r in requests:
            if not r.done and len(r.out) >= r.max_new_tokens:
                # budget exhausted: finished, as serve()'s alive mask has it
                r.done = True
        return requests

    # ------------------------------------------------------------------
    # continuous batching (ScheduleBackend protocol)
    # ------------------------------------------------------------------

    def sched_start(self) -> dict:
        """Fresh scheduler state: empty cache, all slots dead.  With a draft
        its KV ring rides along (``"dcache"``): admission and every spec
        round write both rings in lockstep, so one ``index`` serves both."""
        B, V, dev = self.B, self.cfg.padded_vocab, self.device
        state = {
            "cache": init_cache(self.cfg, B, self.max_len, device=dev),
            "logits": torch.zeros((B, V), dtype=torch.float32, device=dev),
            "live": torch.zeros((B,), dtype=torch.bool, device=dev),
            "index": torch.zeros((B,), dtype=torch.int32, device=dev),
            "remaining": torch.zeros((B,), dtype=torch.int32, device=dev),
            "stop": torch.full((B,), -1, dtype=torch.int32, device=dev),
        }
        if self.spec_k:
            state["dcache"] = init_cache(self.draft_cfg, B, self.max_len,
                                         device=dev)
        return state

    def _validate_request(self, request: Request) -> int:
        plen = len(request.prompt)
        if plen < 1:
            raise ValueError("empty prompt")
        check_prompt_len(self.cfg, plen)
        if not self.cfg.window and plen + request.max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({plen}) + max_new_tokens ({request.max_new_tokens}) "
                f"exceeds engine max_len {self.max_len}")
        return plen

    def sched_admit_start(self, state: dict, slot: int, request: Request):
        """Begin admitting ``request`` into ``slot``: returns ``(state,
        pending)``; feed ``pending`` to :meth:`sched_admit_step` until it
        returns ``None``.  The prefill runs against a private single-row
        cache, so decode steps on the other rows proceed untouched.

        With a prefix store, the store is consulted first: the longest
        hashed-prefix run of cached blocks is spliced into the private cache
        and chunked prefill resumes at the first miss.  The final chunk is
        always computed: the slot needs its last-position logits, which no
        KV slab carries.  Hashing runs on the host from the prompt list;
        the slabs and splices stay on the device.

        A whole-prompt architecture (``chunked_admission`` False) admits in
        this call (:meth:`_admit_whole`) and returns ``(state, None)``."""
        plen = self._validate_request(request)
        if not self.chunked_admission:
            return self._admit_whole(state, slot, request), None
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
        cache1 = init_cache(self.cfg, 1, self.max_len, device=dev)
        hits, hashes = 0, []
        store = self.prefix_store
        if store is not None:
            hashes = store.block_hashes(prompt,
                                        n_blocks=self._publishable_blocks(plen))
            # reusable depth: full blocks strictly before the final chunk;
            # the publishable cap already bounds depth at the ring length
            hits = store.match(hashes[:min(len(chunks) - 1, len(hashes))])
            for i in range(hits):
                splice_kv_blocks(self.cfg, cache1, store.get(hashes[i]), i * C)
            store.stats.reused_tokens += hits * C
        pending = {"request": request, "slot": slot, "chunks": chunks,
                   "i": hits, "hashes": hashes, "cache": cache1,
                   "logits1": None,
                   # the draft has no prefix store: its cursor starts at 0
                   # and it prefills every chunk, catching up in the calls
                   # the target's hits skip
                   "di": 0 if self.spec_k else len(chunks),
                   "dcache": (init_cache(self.draft_cfg, 1, self.max_len,
                                         device=dev)
                              if self.spec_k else None)}
        return state, pending

    def _publishable_blocks(self, plen: int) -> int:
        """How many leading full blocks of a ``plen``-token prompt the
        prefix store may hold: every full ``prefill_chunk`` block, capped on
        windowed configs at the blocks fully inside the first ``CL``
        positions — deeper blocks are overwritten in the ring before the
        prompt's tail attends them, so their slabs could neither be
        extracted after prefill-time wraparound nor spliced usefully."""
        n_full = plen // self.prefill_chunk
        if self.cfg.window:
            n_full = min(n_full, self._CL // self.prefill_chunk)
        return n_full

    def sched_admit_step(self, state: dict, pending: dict):
        """Prefill one prompt chunk; on the last one splice the row into the
        live state and arm the slot.  Returns ``(state, pending | None)``.

        With a prefix store, each freshly computed full block within reuse
        depth is extracted from the just-written ring slots and published,
        so the next request sharing the prefix splices instead of
        recomputing.  With a draft, each call also advances the draft's
        prefill by one chunk (same tokens and positions, its own private
        cache), so the admission takes ``len(chunks)`` calls either way and
        ends with both rings armed."""
        n = len(pending["chunks"])
        if pending["di"] < n:
            toks, pos, take = pending["chunks"][pending["di"]]
            pending["dcache"], _ = model_prefill_chunk(
                self.draft_params, self.draft_cfg, pending["dcache"], toks,
                pos, take)
            pending["di"] += 1
        i = pending["i"]
        if i < n:
            toks, pos, take = pending["chunks"][i]
            pending["cache"], pending["logits1"] = model_prefill_chunk(
                self.params, self.cfg, pending["cache"], toks, pos, take)
            hashes = pending["hashes"]
            if i < len(hashes) and hashes[i] not in self.prefix_store:
                C = self.prefill_chunk
                self.prefix_store.put(hashes[i], extract_kv_blocks(
                    self.cfg, pending["cache"], i * C, C))
            pending["i"] += 1
        if pending["i"] < n or pending["di"] < n:
            return state, pending
        return self._commit(state, pending["slot"], pending["request"],
                            pending["cache"], pending["logits1"][0],
                            pending["dcache"]), None

    def _admit_whole(self, state: dict, slot: int, request: Request) -> dict:
        """Whole-prompt admission: one single-row :func:`prefill` of the
        prompt, committed through the same splice as the chunked path."""
        toks = torch.tensor([request.prompt], dtype=torch.int64,
                            device=self.device)
        _, logits = prefill_into_slot(self.params, self.cfg, state["cache"],
                                      {"tokens": toks, **self._stub_inputs(1)},
                                      slot, self.max_len)
        return self._arm(state, slot, request, logits)

    def _stub_inputs(self, B: int) -> dict:
        """The modality frontends' stand-in inputs for ``B`` rows, as the
        reference engine's: whisper's zero frame embeddings ``[B, enc_seq,
        D]`` and a VLM's zero vision embeddings ``[B, vision_tokens, D]``,
        bf16."""
        cfg, extras = self.cfg, {}
        if cfg.frontend == "audio_stub":
            extras["frames"] = torch.zeros(
                (B, cfg.enc_seq, cfg.d_model), dtype=torch.bfloat16,
                device=self.device)
        if cfg.frontend == "vit_stub":
            extras["vision_embeds"] = torch.zeros(
                (B, cfg.vision_tokens, cfg.d_model), dtype=torch.bfloat16,
                device=self.device)
        return extras

    def prefix_match_len(self, request: Request) -> int:
        """Cached-prefix depth for ``request`` in tokens: how much prefill
        admission would skip right now.  A read-only probe (no LRU bump, no
        hit/miss accounting): the scheduler calls it per queued request to
        order admission by cache affinity.  0 without a store."""
        if self.prefix_store is None:
            return 0
        plen = len(request.prompt)
        n_reusable = min((plen - 1) // self.prefill_chunk,
                         self._publishable_blocks(plen))
        if n_reusable <= 0:
            return 0
        hashes = self.prefix_store.block_hashes(request.prompt,
                                                n_blocks=n_reusable)
        return self.prefix_store.match(hashes, peek=True) * self.prefill_chunk

    def _commit(self, state: dict, slot: int, request: Request, cache1: dict,
                logits1: torch.Tensor, dcache1: dict | None = None) -> dict:
        """Splice a prefilled single-row cache (and the draft's, with a
        draft) into batch row ``slot``, every leaf, KV and recurrent state
        alike, and arm the slot (in place)."""
        splice_rows(state["cache"], slot, cache1)
        if self.spec_k:
            splice_rows(state["dcache"], slot, dcache1)
        return self._arm(state, slot, request, logits1)

    def _arm(self, state: dict, slot: int, request: Request,
             logits1: torch.Tensor) -> dict:
        """Arm batch row ``slot`` for ``request``, whose prompt's last
        logits are ``logits1`` (in place)."""
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

    #: sched_spec_step takes per-slot draft windows (the scheduler's
    #: protocol attribute for dynamic ``spec_k``)
    spec_window_aware = True

    def sched_spec_step(self, state: dict, window=None):
        """One speculative round.  Returns ``(state, cands [B, K], n_acc
        [B], n_emit [B], alive [B])`` as numpy: slot ``b`` emits
        ``cands[b, :n_emit[b]]``, each token the target's own canonical
        greedy choice; ``n_acc[b] - 1`` drafted candidates were accepted.
        ``window`` (``B`` ints in ``[2, spec_k]``; None: ``spec_k``
        everywhere) caps each slot's accepted prefix; the draft and the
        verify still run all ``spec_k`` positions, and the rollback rewinds
        whatever was not accepted.

        The round: the free token ``c0`` from the slot's logits; ``spec_k``
        draft decode steps, which propose ``c1..c_{K-1}`` and write all K
        candidates into the draft ring; one target :func:`verify_step`;
        candidate ``j >= 1`` accepted while it equals the target's greedy
        choice after ``0..j-1`` and lies inside the window; stop and budget
        masking over the accepted prefix; both rings rolled back past it;
        the next logits taken from the last accepted position.  Dead rows
        verify at -1: nothing is written and ``n_acc = n_emit = 0``.  The
        round reads its results back to the host once, and rolls back from
        that copy."""
        if not self.spec_k:
            raise RuntimeError("sched_spec_step requires draft= at engine "
                               "construction")
        B, K, dev = self.B, self.spec_k, self.device
        if window is None:
            window = [K] * B
        w = torch.as_tensor(np.asarray(window, np.int32))
        if w.shape != (B,):
            raise ValueError(f"window must have shape ({B},), got "
                             f"{tuple(w.shape)}")
        w = w.to(dev)
        live, index = state["live"], state["index"]
        start = torch.where(live, index + 1, -1)
        dcache = state["dcache"]
        dundo = snapshot_kv_window(self.draft_cfg, dcache, start, K)
        tok = torch.where(live, greedy_tokens(state["logits"]), PAD_TOKEN)
        cands = []
        for j in range(K):
            cands.append(tok)
            dlogits, dcache = decode_step(
                self.draft_params, self.draft_cfg, dcache, tok,
                torch.where(live, index + 1 + j, -1))
            tok = torch.where(live, greedy_tokens(dlogits), PAD_TOKEN)
        cands = torch.stack(cands, 1)                          # [B, K]
        undo = snapshot_kv_window(self.cfg, state["cache"], start, K)
        vlogits, cache = verify_step(self.params, self.cfg, state["cache"],
                                     cands, start)
        pred = greedy_tokens(vlogits)                          # [B, K]
        j = torch.arange(K, dtype=torch.int32, device=dev)[None, :]
        match = ((cands[:, 1:] == pred[:, :-1])
                 & (j[:, 1:] < w[:, None])).to(torch.int32)
        n_acc = torch.where(live, 1 + torch.cumprod(match, 1).sum(1), 0)
        is_stop = (j < n_acc[:, None]) & (cands == state["stop"][:, None])
        stop_at = torch.where(is_stop, j, K).amin(1)
        n_emit = torch.minimum(torch.minimum(n_acc, stop_at + 1),
                               state["remaining"])
        remaining = state["remaining"] - n_emit
        alive = live & ~(stop_at < n_emit) & (remaining > 0)
        rows = torch.arange(B, device=dev)
        nlog = vlogits[rows, (n_acc - 1).clamp_min(0)]
        logits = torch.where(live[:, None], nlog, state["logits"])
        # the one read-back of the round; the rollbacks index from it
        host = torch.cat([cands.to(torch.int32), n_acc[:, None].int(),
                          n_emit[:, None].int(), alive[:, None].int(),
                          undo["slot"], dundo["slot"]], 1).cpu()
        keep = host[:, K]
        undo["slot"], dundo["slot"] = host[:, K + 3:2 * K + 3], host[:, -K:]
        cache = rollback_kv_window(self.cfg, cache, undo, keep)
        dcache = rollback_kv_window(self.draft_cfg, dcache, dundo, keep)
        state = dict(state, cache=cache, dcache=dcache, logits=logits,
                     index=index + n_acc.to(torch.int32),
                     remaining=remaining.to(torch.int32), live=alive)
        h = host.numpy()
        return (state, h[:, :K], h[:, K], h[:, K + 1],
                h[:, K + 2].astype(bool))

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
