"""Seeded open-loop load generation against the continuous scheduler.

:func:`generate_trace` expands a :class:`~repro_torch.serving.workload.Scenario`
into a flat, time-sorted list of :class:`ArrivalEvent` — every inter-arrival
gap, prompt token, and generation budget drawn from per-tenant
``SeedSequence`` streams, so the same ``(scenario, vocab, seed)`` triple
yields the byte-identical trace on every machine (and the same trace as
the JAX package's load generator).  Open loop means arrivals do NOT wait
for the system: when the server falls behind, the queue grows and the
latency percentiles say so (a closed-loop replay can never show
saturation, because a slow server throttles its own offered load).

:class:`LoadGenerator` replays a trace through a
:class:`~repro_torch.serving.scheduler.ContinuousScheduler` under one of two
clocks:

  * ``clock="virtual"`` — simulated time.  A request is submitted to the
    scheduler only once the virtual clock reaches its arrival time (the
    *admission shim*: queueing delay is real queueing, not replay
    artifact), and each scheduler step advances the clock by a
    deterministic cost model — ``decode_step_cost_s`` per decode step plus
    ``prefill_chunk_cost_s`` per prefill chunk advanced.  Tokens emitted
    during a step become visible at the step's END, after its cost is
    applied, exactly like a real server.  Everything is deterministic.
    The default costs are placeholders for *relative* analysis (scheduling
    policy, admission budgets, tenant interference), not device figures —
    calibrate them from a wall-clock run when absolute numbers matter.
  * ``clock="wall"`` — real time.  The generator sleeps until the next
    arrival and timestamps with ``time.perf_counter``; use this to measure
    an actual engine on the card (``repro_torch.launch.serve
    --scenario``).  A token's timestamp is taken when the host holds it:
    the engine's step reads its tokens back from the device, so that is
    after the device finished the step.

Each request yields a :class:`RequestRecord` with its
arrival/submit/admit/first-token/done timestamps; TTFT is measured from
*arrival* (the user's clock starts when they hit enter, not when the
scheduler notices).

This module also hosts the port's shared :func:`percentile` (linear
interpolation, the numpy default — hand-written so a numpy cross-check is
a genuine independent check) and :func:`latency_summary`, used by the
launch layer.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Any

from repro_torch.serving.engine import Request
from repro_torch.serving.scheduler import ContinuousScheduler, SchedulerStats
from repro_torch.serving.workload import (Scenario, shared_prefix_tokens,
                                          tenant_rng)

__all__ = ["ArrivalEvent", "RequestRecord", "LoadResult", "LoadGenerator",
           "generate_trace", "percentile", "latency_summary"]


# -- shared statistics helpers ----------------------------------------------

def percentile(vals, p: float) -> float:
    """The p-th percentile (0..100) with linear interpolation between order
    statistics — numpy's default method, implemented independently."""
    if not 0.0 <= p <= 100.0:
        raise ValueError(f"percentile must be in [0, 100], got {p}")
    s = sorted(float(v) for v in vals)
    if not s:
        return 0.0
    if len(s) == 1:
        return s[0]
    rank = (p / 100.0) * (len(s) - 1)
    lo = int(math.floor(rank))
    hi = min(lo + 1, len(s) - 1)
    frac = rank - lo
    return s[lo] * (1.0 - frac) + s[hi] * frac


def latency_summary(vals, ndigits: int = 6) -> dict:
    """mean/p50/p95/p99/max of a latency sample (zeros when empty)."""
    s = [float(v) for v in vals]
    if not s:
        return {"mean": 0.0, "p50": 0.0, "p95": 0.0, "p99": 0.0, "max": 0.0}
    return {
        "mean": round(sum(s) / len(s), ndigits),
        "p50": round(percentile(s, 50), ndigits),
        "p95": round(percentile(s, 95), ndigits),
        "p99": round(percentile(s, 99), ndigits),
        "max": round(max(s), ndigits),
    }


# -- trace generation --------------------------------------------------------

@dataclass(frozen=True)
class ArrivalEvent:
    """One request arrival: time, traffic class, and fully-drawn content."""
    t: float
    tenant: str
    tenant_index: int
    prompt: tuple[int, ...]
    new_tokens: int
    #: per-tenant arrival ordinal (stable merge tiebreak)
    seq: int


def generate_trace(scenario: Scenario, vocab_size: int,
                   seed: int = 0) -> list[ArrivalEvent]:
    """Expand ``scenario`` into its deterministic arrival trace.

    Per tenant, three disjoint RNG streams (arrival gaps, lengths+content,
    and one per prefix group) are derived from ``(seed, scenario name,
    tenant index)`` — adding a tenant or reordering the registry never
    perturbs another tenant's draws.  Events merge by ``(t, tenant_index,
    seq)`` and truncate to the ``max_requests`` earliest, which preserves
    the offered rate mix."""
    if vocab_size < 4:
        raise ValueError(f"vocab_size must be >= 4, got {vocab_size}")
    events: list[ArrivalEvent] = []
    for ti, ten in enumerate(scenario.tenants):
        arr_rng = tenant_rng(seed, scenario.name, ti, stream=0)
        len_rng = tenant_rng(seed, scenario.name, ti, stream=1)
        prefixes: list[list[int]] = []
        if ten.shared_prefix_len > 0:
            prefixes = [shared_prefix_tokens(seed, scenario.name, ti, g,
                                             ten.shared_prefix_len,
                                             vocab_size)
                        for g in range(ten.prefix_groups)]
        now, seq = 0.0, 0
        while True:
            now += ten.arrival.next_gap(arr_rng)
            if now > scenario.duration_s:
                break
            n_unique = ten.prompt_len.sample(len_rng)
            unique = [int(t) for t in len_rng.integers(
                2, max(vocab_size - 1, 3), size=n_unique)]
            if prefixes:
                group = int(len_rng.integers(len(prefixes)))
                prompt = tuple(prefixes[group]) + tuple(unique)
            else:
                prompt = tuple(unique)
            events.append(ArrivalEvent(
                t=now, tenant=ten.name, tenant_index=ti, prompt=prompt,
                new_tokens=ten.new_tokens.sample(len_rng), seq=seq))
            seq += 1
    events.sort(key=lambda e: (e.t, e.tenant_index, e.seq))
    return events[:scenario.max_requests]


# -- replay ------------------------------------------------------------------

@dataclass
class RequestRecord:
    """Per-request lifecycle timestamps (seconds on the run's clock)."""
    rid: int
    tenant: str
    prompt_len: int
    new_tokens_requested: int
    t_arrival: float
    t_submit: float = 0.0
    #: backend admission time (``t_submit + scheduler queue wait``)
    t_admit: float | None = None
    t_first_token: float | None = None
    t_done: float | None = None
    n_out: int = 0

    @property
    def ttft_s(self) -> float | None:
        """Time to first token from ARRIVAL (includes queueing)."""
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.t_arrival

    @property
    def tpot_s(self) -> float | None:
        """Mean time per output token after the first (needs >= 2 tokens)."""
        if self.t_done is None or self.t_first_token is None or \
                self.n_out < 2:
            return None
        return (self.t_done - self.t_first_token) / (self.n_out - 1)

    @property
    def queue_wait_s(self) -> float | None:
        if self.t_admit is None:
            return None
        return self.t_admit - self.t_submit

    @property
    def e2e_s(self) -> float | None:
        if self.t_done is None:
            return None
        return self.t_done - self.t_arrival


@dataclass
class LoadResult:
    records: list[RequestRecord]
    #: first arrival to last completion, on the run's clock
    makespan_s: float
    #: requests/s the trace asked for (n / span of arrivals)
    offered_qps: float
    #: requests/s actually completed (n / makespan)
    achieved_qps: float
    stats: SchedulerStats
    clock: str
    emitted_tokens: int = 0

    def by_tenant(self) -> dict[str, list[RequestRecord]]:
        out: dict[str, list[RequestRecord]] = {}
        for r in self.records:
            out.setdefault(r.tenant, []).append(r)
        return out


class LoadGenerator:
    """Open-loop replay of an arrival trace against a scheduler backend.

    ``backend`` is any :class:`~repro_torch.serving.scheduler.ScheduleBackend`
    (a real :class:`~repro_torch.serving.engine.DecodeEngine` or a test
    fake).  ``admission_budget`` and ``dynamic_spec_k`` pass through to
    the scheduler, which orders admission by cache affinity on a backend
    with a prefix store.  See the module docstring for the two clocks."""

    def __init__(self, backend: Any, trace: list[ArrivalEvent], *,
                 clock: str = "virtual",
                 decode_step_cost_s: float = 0.01,
                 prefill_chunk_cost_s: float = 0.02,
                 stop_token: int | None = None,
                 admission_budget: int | None = None,
                 dynamic_spec_k: bool = False):
        if clock not in ("virtual", "wall"):
            raise ValueError(f"clock must be 'virtual' or 'wall', got "
                             f"{clock!r}")
        if decode_step_cost_s <= 0 or prefill_chunk_cost_s <= 0:
            raise ValueError("virtual step costs must be > 0")
        self.backend = backend
        self.trace = list(trace)
        self.clock = clock
        self.decode_step_cost_s = decode_step_cost_s
        self.prefill_chunk_cost_s = prefill_chunk_cost_s
        self.stop_token = stop_token
        self._now = 0.0
        self._t0 = 0.0
        self._buffer: list[tuple[Request, int]] = []
        self.sched = ContinuousScheduler(
            backend, on_token=self._on_token,
            admission_budget=admission_budget,
            clock=self._read_clock, dynamic_spec_k=dynamic_spec_k)
        self.records: dict[int, RequestRecord] = {}

    def _read_clock(self) -> float:
        if self.clock == "virtual":
            return self._now
        return time.perf_counter() - self._t0

    def _on_token(self, req: Request, tok: int) -> None:
        # buffered: tokens become visible at end-of-step, after the step's
        # clock cost is applied (see run())
        self._buffer.append((req, tok))

    def _submit_due(self, i: int) -> int:
        """Submit every event whose arrival time has passed; returns the new
        trace cursor.  This IS the virtual-clock admission shim: the
        scheduler cannot see a request before its arrival time."""
        now = self._read_clock()
        while i < len(self.trace) and self.trace[i].t <= now:
            ev = self.trace[i]
            req = Request(prompt=list(ev.prompt),
                          max_new_tokens=ev.new_tokens,
                          stop_token=self.stop_token, tenant=ev.tenant)
            self.records[req.rid] = RequestRecord(
                rid=req.rid, tenant=ev.tenant, prompt_len=len(ev.prompt),
                new_tokens_requested=ev.new_tokens, t_arrival=ev.t,
                t_submit=now)
            self.sched.submit(req)
            i += 1
        return i

    def _drain_buffer(self) -> None:
        now = self._read_clock()
        for req, _tok in self._buffer:
            rec = self.records[req.rid]
            rec.n_out += 1
            if rec.t_first_token is None:
                rec.t_first_token = now
        self._buffer.clear()

    def run(self, max_steps: int | None = 200_000) -> LoadResult:
        if not self.trace:
            raise ValueError("empty arrival trace")
        self._now, self._t0 = 0.0, time.perf_counter()
        sched, stats = self.sched, self.sched.stats
        atomic = not hasattr(self.backend, "sched_admit_start")
        i, steps = 0, 0
        while i < len(self.trace) or sched.pending:
            if not sched.pending and i < len(self.trace) and \
                    self.trace[i].t > self._read_clock():
                # idle: jump (virtual) or sleep (wall) to the next arrival
                if self.clock == "virtual":
                    self._now = self.trace[i].t
                else:
                    time.sleep(max(self.trace[i].t - self._read_clock(), 0))
            i = self._submit_due(i)
            if not sched.pending:
                continue
            chunks0, steps0, adm0, admitted0 = (
                stats.prefill_chunks, stats.steps, stats.admission_steps,
                stats.admitted)
            finished = sched.step()
            if self.clock == "virtual":
                dchunks = stats.prefill_chunks - chunks0
                ddecode = (stats.steps - steps0) - \
                    (stats.admission_steps - adm0)
                # atomic-admission backends prefill whole prompts inside
                # sched_admit; charge one chunk per admission so admission
                # is never free
                datomic = (stats.admitted - admitted0) if atomic else 0
                cost = (dchunks + datomic) * self.prefill_chunk_cost_s \
                    + ddecode * self.decode_step_cost_s
                self._now += max(cost, 1e-9)
            self._drain_buffer()
            done_t = self._read_clock()
            for req in finished:
                self.records[req.rid].t_done = done_t
            # admit times are derivable once the scheduler recorded the wait
            for rid, wait in stats.queue_wait_by_rid.items():
                rec = self.records.get(rid)
                if rec is not None and rec.t_admit is None:
                    rec.t_admit = rec.t_submit + wait
            steps += 1
            if max_steps is not None and steps > max_steps:
                raise RuntimeError(
                    f"load run exceeded {max_steps} steps with "
                    f"{sched.num_queued} queued / {sched.num_active} active")
        records = sorted(self.records.values(), key=lambda r: r.rid)
        t_end = max((r.t_done for r in records if r.t_done is not None),
                    default=0.0)
        t_first = min(r.t_arrival for r in records)
        arrival_span = max(records[-1].t_arrival - t_first, 1e-9)
        makespan = max(t_end - t_first, 1e-9)
        return LoadResult(
            records=records, makespan_s=makespan,
            offered_qps=len(records) / arrival_span,
            achieved_qps=sum(r.t_done is not None for r in records)
            / makespan,
            stats=stats, clock=self.clock,
            emitted_tokens=stats.emitted_tokens)
