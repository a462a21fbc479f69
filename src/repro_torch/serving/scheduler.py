"""Continuous-batching decode scheduler.

The scheduler keeps every slot busy:

  * **FIFO admission queue** — ``submit()`` order is admission order,
    except that on a backend with a prefix cache a cache-hot request may
    be admitted ahead of older ones within a small window (cache affinity,
    with a starvation bound);
  * **per-slot lifecycle** — the moment a slot's request finishes (stop
    token or token budget), the slot is refilled from the queue mid-flight,
    without touching the other rows or re-prefilling the batch;
  * **chunked, budgeted admission** — on backends that implement incremental
    admission (``sched_admit_start`` / ``sched_admit_step``,
    e.g. :class:`repro_torch.serving.engine.DecodeEngine` via
    :func:`repro_torch.models.decode.prefill_chunk`), a prompt is prefilled a
    fixed-size chunk at a time and ``admission_budget`` caps chunks per
    step, so a long arriving prompt cannot stall co-batched decode — their
    time-to-next-token stays bounded by one decode step plus ``budget``
    chunks;
  * **streaming callbacks** — ``on_token(request, token)`` fires as each
    token is emitted (per-request ``Request.on_token`` overrides the
    scheduler-wide callback);
  * **on-device stop masking** — the stop-token compare, budget countdown,
    and liveness mask are computed inside the backend's step, so the decode
    loop never branches on the host per token; the host reads back one small
    ``(tokens, alive)`` pair per step to drive streaming and refills.

The scheduler is pure host-side bookkeeping over a narrow backend protocol
(:class:`ScheduleBackend`), implemented for real models by
:class:`repro_torch.serving.engine.DecodeEngine`.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Protocol, runtime_checkable

from repro_torch.serving.engine import Request

__all__ = ["ContinuousScheduler", "ScheduleBackend", "SchedulerStats", "Request"]

#: cache-affinity lookahead: a free slot admits the deepest prefix match
#: among the first this many queued requests
AFFINITY_WINDOW = 8
#: the starvation bound: a queue head jumped this many times on affinity is
#: admitted next, whatever the matches behind it
MAX_AFFINITY_SKIPS = 4
#: dynamic ``spec_k``: weight of the newest round in a request's EWMA of
#: its accepted-draft fraction
SPEC_ACC_EWMA = 0.5


@runtime_checkable
class ScheduleBackend(Protocol):
    """What the scheduler drives.  ``state`` is opaque to the scheduler.

    ``sched_step`` returns ``(state, tokens, alive)`` where ``tokens[b]`` is
    the token just emitted by slot ``b`` and ``alive[b]`` is False once slot
    ``b``'s request has finished (stop token hit or budget exhausted).
    Entries for slots the scheduler holds no request in are ignored.

    A backend may additionally implement **incremental admission** —
    ``sched_admit_start(state, slot, request) -> (state, pending | None)``
    and ``sched_admit_step(state, pending) -> (state, pending | None)`` —
    where each ``sched_admit_step`` prefills one prompt chunk and ``None``
    marks the slot armed.  The scheduler then interleaves admission chunks
    with decode steps under ``admission_budget``; backends without the pair
    are admitted atomically via ``sched_admit``.

    A backend may also expose **cache affinity** —
    ``prefix_match_len(request) -> int``, the number of prompt tokens whose
    prefill a prefix cache would skip right now (a read-only probe) — which
    lets the scheduler admit cache-hot requests first (see
    :meth:`ContinuousScheduler._pop_next`).

    A backend may also speak the **speculative accept/rollback step**: an
    int attribute ``spec_k >= 2`` and ``sched_spec_step(state, window) ->
    (state, tokens, n_acc, n_emit, alive)``, where ``tokens`` is ``[B,
    spec_k]`` candidates, slot ``b`` emits exactly ``tokens[b,
    :n_emit[b]]`` (the backend has already rolled back every rejected
    candidate), ``n_acc[b] - 1`` counts its accepted drafted tokens, and
    ``window`` (``B`` ints in ``[2, spec_k]``, or None for ``spec_k``
    everywhere) caps each slot's accepted prefix.  The scheduler then
    drives ``sched_spec_step`` instead of ``sched_step`` and fans each
    slot's ragged window out to the per-token callbacks.
    """

    batch_size: int

    def sched_start(self) -> Any: ...

    def sched_admit(self, state: Any, slot: int, request: Request) -> Any: ...

    def sched_step(self, state: Any) -> tuple[Any, Any, Any]: ...


@dataclass
class SchedulerStats:
    #: every :meth:`ContinuousScheduler.step` call — decode steps AND
    #: admission-only steps (no slot live yet, prefill chunks advancing)
    steps: int = 0
    #: steps that did admission work but ran no decode; wall-clock spent
    #: here is prefill, not decode, so throughput math must not divide by it
    admission_steps: int = 0
    admitted: int = 0
    completed: int = 0
    emitted_tokens: int = 0
    #: prefill chunks advanced through incremental admission
    prefill_chunks: int = 0
    #: per-request wait from ``submit()`` to backend admission on the
    #: scheduler's clock, in admission order — the fairness cost of
    #: cache-affinity reordering shows here next to the TTFT it buys
    #: (zero-budget requests never occupy a slot and are left out).
    #: Recorded on every admission path (FIFO, affinity reorder, atomic,
    #: incremental), and mirrored per request in :attr:`queue_wait_by_rid`
    queue_wait_s: list[float] = field(default_factory=list)
    #: the same waits keyed on ``Request.rid`` (what the load generator's
    #: per-tenant analysis joins against)
    queue_wait_by_rid: dict[int, float] = field(default_factory=dict)
    #: admissions that jumped ahead of an older queued request on cache
    #: affinity (0 under pure FIFO)
    affinity_reorders: int = 0
    #: speculative rounds run (0 on non-speculative backends)
    spec_rounds: int = 0
    #: candidates drafted across live slots (``window - 1`` per live slot
    #: per round)
    drafted_tokens: int = 0
    #: drafted candidates the target accepted (``n_acc - 1`` summed over
    #: live slots); ``accepted / drafted`` is the acceptance rate
    accepted_drafted_tokens: int = 0
    #: accepted drafted tokens per request, keyed on ``Request.rid``
    accepted_by_rid: dict[int, int] = field(default_factory=dict)
    #: each request's draft window in its latest round (dynamic ``spec_k``
    #: only)
    spec_window_by_rid: dict[int, int] = field(default_factory=dict)

    @property
    def decode_steps(self) -> int:
        """Steps that ran a backend decode (``sched_step`` or
        ``sched_spec_step``) — the number serving benchmarks report as
        decode steps."""
        return self.steps - self.admission_steps

    @property
    def acceptance_rate(self) -> float:
        """Fraction of drafted candidates the target accepted (0.0 when
        nothing was drafted)."""
        if not self.drafted_tokens:
            return 0.0
        return self.accepted_drafted_tokens / self.drafted_tokens

    def queue_wait_summary(self) -> dict:
        """mean/p50/max of per-request queue wait (seconds; zeros when no
        request was admitted)."""
        if not self.queue_wait_s:
            return {"mean": 0.0, "p50": 0.0, "max": 0.0}
        w = sorted(self.queue_wait_s)
        return {"mean": sum(w) / len(w), "p50": w[len(w) // 2], "max": w[-1]}


class ContinuousScheduler:
    """FIFO continuous-batching scheduler over a :class:`ScheduleBackend`."""

    def __init__(self, backend: ScheduleBackend,
                 on_token: Callable[[Request, int], None] | None = None,
                 admission_budget: int | None = None,
                 clock: Callable[[], float] | None = None,
                 dynamic_spec_k: bool = False):
        """``admission_budget`` caps how many prefill chunks advance per
        :meth:`step` across all in-flight admissions (None = finish each
        admission within the step it starts).  With a budget, a long prompt
        is admitted a few chunks at a time while co-batched live slots keep
        decoding — bounding their time-to-first/next-token.  Only effective
        on backends implementing incremental admission (see
        :class:`ScheduleBackend`).

        On backends that expose ``prefix_match_len(request) -> int`` (a
        :class:`~repro_torch.serving.engine.DecodeEngine`), admission is
        ordered by prefix-cache affinity: each free slot admits the
        deepest-matching request among the first :data:`AFFINITY_WINDOW`
        queued, so a request whose shared prefix is hot runs while the
        blocks are still resident.  The FIFO fairness bound: ties
        (including the no-store all-zero case) go to the oldest request,
        and once the queue head has been jumped :data:`MAX_AFFINITY_SKIPS`
        times it is admitted unconditionally.

        ``clock`` is the time source for queue-wait accounting (default
        ``time.perf_counter``); a virtual-clock load generator injects its
        own.

        ``dynamic_spec_k`` (speculative backends) sizes each request's next
        draft window from its measured acceptance: an EWMA of the per-round
        accepted fraction (weight :data:`SPEC_ACC_EWMA` on the newest
        round, starting at 1.0) maps to a window in ``[2, spec_k]``, so a
        request whose drafts keep being rejected soon drafts one token a
        round while well-predicted ones keep the full ``spec_k``."""
        if admission_budget is not None and admission_budget < 1:
            raise ValueError("admission_budget must be >= 1 (or None)")
        self.backend = backend
        self.B = backend.batch_size
        self.on_token = on_token
        self.admission_budget = admission_budget
        self.clock = clock if clock is not None else time.perf_counter
        self.dynamic_spec_k = dynamic_spec_k
        #: request.rid → EWMA of its per-round accepted-draft fraction
        self._acc_ewma: dict[int, float] = {}
        #: request.rid → times an affinity pick jumped it while queued
        self._skips: dict[int, int] = {}
        #: request.rid → clock() at submit (queue-wait accounting)
        self._enqueue_t: dict[int, float] = {}
        self.queue: deque[Request] = deque()
        self.slots: list[Request | None] = [None] * self.B
        #: slot → (request, backend pending) for prefills in flight; dict
        #: order is admission order, so budget drains FIFO
        self.prefilling: dict[int, tuple[Request, Any]] = {}
        self.completed: list[Request] = []
        #: requests in the order they were handed to the backend
        self.admission_order: list[Request] = []
        self.stats = SchedulerStats()
        self._state: Any = None

    # -- introspection ------------------------------------------------------

    @property
    def num_active(self) -> int:
        return sum(r is not None for r in self.slots)

    @property
    def num_prefilling(self) -> int:
        return len(self.prefilling)

    @property
    def num_queued(self) -> int:
        return len(self.queue)

    @property
    def pending(self) -> bool:
        return bool(self.queue) or self.num_active > 0 or bool(self.prefilling)

    # -- driving ------------------------------------------------------------

    def submit(self, request: Request) -> None:
        """Enqueue a request (FIFO arrival order; admission may reorder
        within the affinity window).  Safe to call mid-run, between
        steps."""
        if request.done:
            raise ValueError("request already completed; submit a fresh one")
        self._enqueue_t[request.rid] = self.clock()
        self.queue.append(request)

    def _pop_next(self) -> Request:
        """Pop the next request to admit.  Pure FIFO unless the backend can
        score prefix matches; then the deepest match within the lookahead
        window wins, ties to the oldest, and a head that has been jumped
        :data:`MAX_AFFINITY_SKIPS` times is forced (the starvation
        bound)."""
        match_len = getattr(self.backend, "prefix_match_len", None)
        if match_len is None or len(self.queue) == 1:
            return self.queue.popleft()
        head = self.queue[0]
        if self._skips.get(head.rid, 0) >= MAX_AFFINITY_SKIPS:
            self._skips.pop(head.rid, None)
            return self.queue.popleft()
        best_i, best = 0, -1
        for i in range(min(len(self.queue), AFFINITY_WINDOW)):
            m = match_len(self.queue[i])
            if m > best:
                best_i, best = i, m
        req = self.queue[best_i]
        del self.queue[best_i]
        self._skips.pop(req.rid, None)
        if best_i > 0:
            self.stats.affinity_reorders += 1
            for j in range(best_i):  # everyone older than the pick was jumped
                jumped = self.queue[j]
                self._skips[jumped.rid] = self._skips.get(jumped.rid, 0) + 1
        return req

    def _record_admission(self, req: Request) -> None:
        t0 = self._enqueue_t.pop(req.rid, None)
        if t0 is not None:
            wait = self.clock() - t0
            self.stats.queue_wait_s.append(wait)
            self.stats.queue_wait_by_rid[req.rid] = wait

    def _admit_free_slots(self) -> None:
        start = getattr(self.backend, "sched_admit_start", None)
        for slot in range(self.B):
            if self.slots[slot] is not None or slot in self.prefilling:
                continue
            while self.queue:
                req = self._pop_next()
                if req.max_new_tokens <= 0:  # zero-budget: completes at once
                    req.done = True
                    self._enqueue_t.pop(req.rid, None)
                    self.completed.append(req)
                    self.stats.completed += 1
                    continue
                if start is None:  # atomic-admission backend
                    self._state = self.backend.sched_admit(self._state, slot,
                                                           req)
                    self.slots[slot] = req
                else:
                    self._state, pend = start(self._state, slot, req)
                    if pend is None:
                        self.slots[slot] = req
                    else:
                        self.prefilling[slot] = (req, pend)
                self.admission_order.append(req)
                self._record_admission(req)
                self.stats.admitted += 1
                break

    def _advance_prefills(self) -> None:
        """Advance in-flight admissions FIFO, at most ``admission_budget``
        prefill chunks this step (None = drain them all)."""
        budget = self.admission_budget
        for slot in list(self.prefilling):
            while True:
                if budget is not None and budget <= 0:
                    return
                req, pend = self.prefilling[slot]
                self._state, pend = self.backend.sched_admit_step(self._state,
                                                                  pend)
                self.stats.prefill_chunks += 1
                if budget is not None:
                    budget -= 1
                if pend is None:  # admission complete: slot is live
                    del self.prefilling[slot]
                    self.slots[slot] = req
                    break
                self.prefilling[slot] = (req, pend)

    def step(self) -> list[Request]:
        """Admit into free slots, advance in-flight prefills under the
        admission budget, run one decode step, deliver tokens.

        Returns the requests that finished this step (possibly empty)."""
        if self._state is None:
            self._state = self.backend.sched_start()
        self._admit_free_slots()
        self._advance_prefills()
        if self.num_active == 0:
            # pure-admission step: prefill chunks advanced, nothing to decode
            # — still a step (it consumed wall-clock), tallied separately so
            # decode throughput math stays honest
            self.stats.steps += 1
            self.stats.admission_steps += 1
            return []
        if getattr(self.backend, "spec_k", 0) >= 2:
            return self._spec_step()
        self._state, tokens, alive = self.backend.sched_step(self._state)
        finished: list[Request] = []
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            tok = int(tokens[slot])
            req.out.append(tok)
            self.stats.emitted_tokens += 1
            cb = req.on_token or self.on_token
            if cb is not None:
                cb(req, tok)
            if not bool(alive[slot]):
                req.done = True
                self.slots[slot] = None
                self.completed.append(req)
                self.stats.completed += 1
                finished.append(req)
        self.stats.steps += 1
        return finished

    def _spec_window(self, req: Request, K: int) -> int:
        """Next-round draft window for ``req``: the full ``K`` until its
        first round, then ``2 + round(ewma · (K - 2))``, in ``[2, K]``, so
        every round still verifies at least one drafted token and
        acceptance can be measured again."""
        ewma = self._acc_ewma.get(req.rid, 1.0)
        return max(2, min(K, 2 + int(round(ewma * (K - 2)))))

    def _spec_step(self) -> list[Request]:
        """One speculative round: every live slot emits a ragged 1..spec_k
        token window in order, streaming callbacks fire per token, and
        acceptance is tallied globally and per request.  Under
        ``dynamic_spec_k`` each slot's window is sized from its request's
        acceptance before the round runs."""
        K = self.backend.spec_k
        window = [K] * self.B
        if self.dynamic_spec_k:
            window = [K if req is None else self._spec_window(req, K)
                      for req in self.slots]
        self._state, tokens, n_acc, n_emit, alive = \
            self.backend.sched_spec_step(self._state, window)
        self.stats.spec_rounds += 1
        finished: list[Request] = []
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            w = window[slot]
            accepted = max(int(n_acc[slot]) - 1, 0)
            self.stats.drafted_tokens += w - 1
            self.stats.accepted_drafted_tokens += accepted
            self.stats.accepted_by_rid[req.rid] = \
                self.stats.accepted_by_rid.get(req.rid, 0) + accepted
            if self.dynamic_spec_k:
                self.stats.spec_window_by_rid[req.rid] = w
                self._acc_ewma[req.rid] = (
                    SPEC_ACC_EWMA * accepted / (w - 1)
                    + (1.0 - SPEC_ACC_EWMA) * self._acc_ewma.get(req.rid, 1.0))
            cb = req.on_token or self.on_token
            for j in range(int(n_emit[slot])):
                tok = int(tokens[slot, j])
                req.out.append(tok)
                self.stats.emitted_tokens += 1
                if cb is not None:
                    cb(req, tok)
            if not bool(alive[slot]):
                req.done = True
                self.slots[slot] = None
                self._acc_ewma.pop(req.rid, None)
                self.completed.append(req)
                self.stats.completed += 1
                finished.append(req)
        self.stats.steps += 1
        return finished

    def run(self, max_steps: int | None = None) -> list[Request]:
        """Drain: step until every submitted request completes.

        Returns completed requests in completion order (``admission_order``
        has admission order).  ``max_steps`` bounds runaway loops (RuntimeError).
        """
        steps = 0
        while self.pending:
            if max_steps is not None and steps >= max_steps:
                raise RuntimeError(
                    f"scheduler did not drain in {max_steps} steps: "
                    f"{self.num_active} active, {self.num_prefilling} "
                    f"prefilling, {self.num_queued} queued")
            self.step()
            steps += 1
        return list(self.completed)
