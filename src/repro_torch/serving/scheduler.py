"""Continuous-batching decode scheduler.

The scheduler keeps every slot busy:

  * **FIFO admission queue** — ``submit()`` order is admission order;
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

from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Protocol, runtime_checkable

from repro_torch.serving.engine import Request

__all__ = ["ContinuousScheduler", "ScheduleBackend", "SchedulerStats", "Request"]


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

    @property
    def decode_steps(self) -> int:
        """Steps that ran a backend decode — the number serving benchmarks
        report as decode steps."""
        return self.steps - self.admission_steps


class ContinuousScheduler:
    """FIFO continuous-batching scheduler over a :class:`ScheduleBackend`."""

    def __init__(self, backend: ScheduleBackend,
                 on_token: Callable[[Request, int], None] | None = None,
                 admission_budget: int | None = None):
        """``admission_budget`` caps how many prefill chunks advance per
        :meth:`step` across all in-flight admissions (None = finish each
        admission within the step it starts).  With a budget, a long prompt
        is admitted a few chunks at a time while co-batched live slots keep
        decoding — bounding their time-to-first/next-token.  Only effective
        on backends implementing incremental admission (see
        :class:`ScheduleBackend`)."""
        if admission_budget is not None and admission_budget < 1:
            raise ValueError("admission_budget must be >= 1 (or None)")
        self.backend = backend
        self.B = backend.batch_size
        self.on_token = on_token
        self.admission_budget = admission_budget
        self.queue: deque[Request] = deque()
        self.slots: list[Request | None] = [None] * self.B
        #: slot → (request, backend pending) for prefills in flight; dict
        #: order is admission order, so budget drains FIFO
        self.prefilling: dict[int, tuple[Request, Any]] = {}
        self.completed: list[Request] = []
        #: requests in the order they were handed to the backend (FIFO proof)
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
        """Enqueue a request (FIFO).  Safe to call mid-run, between steps."""
        if request.done:
            raise ValueError("request already completed; submit a fresh one")
        self.queue.append(request)

    def _admit_free_slots(self) -> None:
        start = getattr(self.backend, "sched_admit_start", None)
        for slot in range(self.B):
            if self.slots[slot] is not None or slot in self.prefilling:
                continue
            while self.queue:
                req = self.queue.popleft()
                if req.max_new_tokens <= 0:  # zero-budget: completes at once
                    req.done = True
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

    def run(self, max_steps: int | None = None) -> list[Request]:
        """Drain: step until every submitted request completes.

        Returns completed requests in completion order (``admission_order``
        has FIFO order).  ``max_steps`` bounds runaway loops (RuntimeError).
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
