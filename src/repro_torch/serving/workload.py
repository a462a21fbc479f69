"""Declarative multi-tenant serving workloads (named scenarios).

Real load is not a fixed request list replayed at one batch size: requests
*arrive* — Poisson for open user populations, bursty for agentic tool
loops, near-constant for machine traffic — from several tenants at once,
each with its own prompt/generation length distributions, shared-prefix
structure (system prompts, RAG templates, resent conversation state), and
latency SLOs.  This module describes such traffic declaratively, the way
``llm-d-benchmark``'s workload profiles do, so a scenario is data that
every harness (launcher, smoke run, test) interprets identically:

  * :class:`Dist` — a bounded integer length distribution (``fixed`` /
    ``uniform`` / ``lognormal`` / ``choice``).  Bounded on purpose: the
    engine's ``max_len`` and the KV ring geometry are derived from
    ``upper()`` before any request is drawn.
  * :class:`ArrivalProcess` — ``poisson`` (exponential inter-arrivals),
    ``gamma_burst`` (gamma inter-arrivals with coefficient of variation
    ``cv`` > 1: bursts separated by lulls, same mean rate), or ``fixed``
    (constant spacing).
  * :class:`TenantSpec` — one traffic class: its arrival process, length
    distributions, shared-prefix structure (``shared_prefix_len`` tokens
    drawn per ``prefix_groups`` distinct group), and per-tenant TTFT/TPOT
    SLO thresholds.
  * :class:`Scenario` — a named set of tenants plus a generation horizon.
    ``scaled(f)`` multiplies every tenant's arrival rate by ``f`` (the
    saturation-sweep knob); ``smoke()`` shrinks lengths/volume to the
    CPU-test operating point without changing the traffic *shape*.

Everything downstream is seeded and deterministic: the same ``(scenario,
vocab, seed)`` triple always yields the byte-identical arrival trace (see
:mod:`repro_torch.serving.loadgen`) — the same trace, byte for byte, as the
JAX package's copy of this module draws, since the salts and
``SeedSequence`` streams below are the same.

The four built-in scenarios mirror the paper family's deployment stories
(Bitnet.cpp-style edge chat, RAG long-prefill, agentic bursts,
code-completion short-gen); ``get_scenario(name)`` resolves them.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, replace

import numpy as np

__all__ = ["Dist", "ArrivalProcess", "TenantSpec", "Scenario",
           "SCENARIOS", "get_scenario", "tenant_rng", "shared_prefix_tokens"]


@dataclass(frozen=True)
class Dist:
    """Bounded integer distribution.  ``kind`` ∈ {fixed, uniform, lognormal,
    choice}; ``a``/``b`` are (value,), (lo, hi), (median, hi) respectively;
    ``sigma`` is the lognormal shape; ``choices`` the choice support."""

    kind: str
    a: int = 1
    b: int = 1
    sigma: float = 0.5
    choices: tuple[int, ...] = ()

    def __post_init__(self):
        if self.kind not in ("fixed", "uniform", "lognormal", "choice"):
            raise ValueError(f"unknown Dist kind {self.kind!r}")
        if self.kind == "choice" and not self.choices:
            raise ValueError("choice Dist needs a non-empty support")
        if self.kind in ("uniform", "lognormal") and self.b < self.a:
            raise ValueError(f"Dist upper bound {self.b} < lower {self.a}")

    def sample(self, rng: np.random.Generator) -> int:
        if self.kind == "fixed":
            return int(self.a)
        if self.kind == "uniform":
            return int(rng.integers(self.a, self.b + 1))
        if self.kind == "choice":
            return int(self.choices[rng.integers(len(self.choices))])
        # lognormal around median ``a`` (lognormal's median IS exp(mu)),
        # clipped into [1, b] so the engine geometry bound holds
        v = int(round(self.a * float(np.exp(self.sigma
                                            * rng.standard_normal()))))
        return int(min(max(v, 1), self.b))

    def upper(self) -> int:
        """Hard upper bound of the support (engine max_len derivation)."""
        if self.kind == "fixed":
            return int(self.a)
        if self.kind == "choice":
            return int(max(self.choices))
        return int(self.b)

    def shrunk(self, factor: int, lo: int = 2) -> "Dist":
        """Divide the support by ``factor`` with a floor — the smoke
        transformation (same shape, CPU-test sized)."""
        sc = lambda v: max(int(v) // factor, lo)
        if self.kind == "choice":
            return replace(self, choices=tuple(sorted({sc(c)
                                                       for c in self.choices})))
        a, b = sc(self.a), sc(self.b)
        return replace(self, a=a, b=max(a, b))


@dataclass(frozen=True)
class ArrivalProcess:
    """Open-loop arrival process at mean ``rate`` requests/second.

    ``poisson``: exponential inter-arrivals (memoryless user population).
    ``gamma_burst``: gamma inter-arrivals with coefficient of variation
    ``cv`` — shape ``1/cv²``, scale ``cv²/rate`` (mean ``1/rate``); cv > 1
    clumps arrivals into bursts separated by long gaps, the agentic
    tool-loop shape.  ``fixed``: constant ``1/rate`` spacing.
    """

    kind: str
    rate: float
    cv: float = 2.0

    def __post_init__(self):
        if self.kind not in ("poisson", "gamma_burst", "fixed"):
            raise ValueError(f"unknown arrival kind {self.kind!r}")
        if self.rate <= 0:
            raise ValueError(f"arrival rate must be > 0, got {self.rate}")
        if self.kind == "gamma_burst" and self.cv <= 0:
            raise ValueError(f"gamma_burst cv must be > 0, got {self.cv}")

    def next_gap(self, rng: np.random.Generator) -> float:
        if self.kind == "fixed":
            return 1.0 / self.rate
        if self.kind == "poisson":
            return float(rng.exponential(1.0 / self.rate))
        shape = 1.0 / (self.cv ** 2)
        scale = (self.cv ** 2) / self.rate
        return float(rng.gamma(shape, scale))

    def scaled(self, f: float) -> "ArrivalProcess":
        return replace(self, rate=self.rate * f)


@dataclass(frozen=True)
class TenantSpec:
    """One traffic class: arrivals, lengths, prefix sharing, SLOs.

    ``prompt_len`` draws the UNIQUE part of each prompt; the total prompt is
    ``shared_prefix_len + prompt_len`` tokens, with the shared prefix drawn
    once per ``(tenant, group)`` — ``prefix_groups`` distinct prefixes
    rotate uniformly, so a prefix cache sees realistic partial sharing
    rather than one global system prompt.  ``slo_ttft_s`` / ``slo_tpot_s``
    are the per-tenant attainment thresholds the analysis layer scores
    against."""

    name: str
    arrival: ArrivalProcess
    prompt_len: Dist
    new_tokens: Dist
    shared_prefix_len: int = 0
    prefix_groups: int = 1
    slo_ttft_s: float = 1.0
    slo_tpot_s: float = 0.1

    def max_prompt_len(self) -> int:
        return self.shared_prefix_len + self.prompt_len.upper()


@dataclass(frozen=True)
class Scenario:
    """A named multi-tenant workload over a generation horizon.

    Arrivals are generated per tenant until ``duration_s`` of virtual time,
    merged by arrival time, and truncated to the ``max_requests`` earliest
    (truncation preserves the rate mix).  ``smoke_*`` parameterize the
    CPU-test shrink applied by :meth:`smoke`."""

    name: str
    description: str
    tenants: tuple[TenantSpec, ...]
    duration_s: float = 60.0
    max_requests: int = 2048
    smoke_len_factor: int = 8
    smoke_duration_s: float = 4.0
    smoke_max_requests: int = 24

    def __post_init__(self):
        if not self.tenants:
            raise ValueError(f"scenario {self.name!r} has no tenants")
        names = [t.name for t in self.tenants]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant names in {self.name!r}")

    def scaled(self, f: float) -> "Scenario":
        """Multiply every tenant's arrival rate by ``f`` (saturation-sweep
        knob); lengths and SLOs are untouched."""
        return replace(self, tenants=tuple(
            replace(t, arrival=t.arrival.scaled(f)) for t in self.tenants))

    def smoke(self) -> "Scenario":
        """The CPU-test operating point: same tenants, same arrival shapes,
        lengths shrunk by ``smoke_len_factor``, shorter horizon, capped
        request count.  SLOs are NOT shrunk — the virtual-clock cost model
        (see loadgen) keeps them meaningful at smoke scale."""
        f = self.smoke_len_factor
        tenants = tuple(replace(
            t,
            prompt_len=t.prompt_len.shrunk(f),
            new_tokens=t.new_tokens.shrunk(f, lo=3),
            shared_prefix_len=(max(t.shared_prefix_len // f, 8)
                               if t.shared_prefix_len else 0),
        ) for t in self.tenants)
        return replace(self, tenants=tenants,
                       duration_s=self.smoke_duration_s,
                       max_requests=self.smoke_max_requests)

    def max_prompt_len(self) -> int:
        return max(t.max_prompt_len() for t in self.tenants)

    def max_new_tokens(self) -> int:
        return max(t.new_tokens.upper() for t in self.tenants)

    def offered_qps(self) -> float:
        """Mean offered load (sum of tenant rates)."""
        return sum(t.arrival.rate for t in self.tenants)

    def slo_ttft_budget(self) -> float:
        """The loosest tenant TTFT SLO — the saturation sweep's default
        p99-TTFT budget (the system is 'sustaining' a rate only if even the
        most lenient class still attains)."""
        return max(t.slo_ttft_s for t in self.tenants)


def _salt(name: str) -> int:
    """Stable 32-bit scenario/tenant salt (NOT Python's randomized hash)."""
    return zlib.crc32(name.encode())


def tenant_rng(seed: int, scenario: str, tenant_index: int,
               stream: int = 0) -> np.random.Generator:
    """The per-tenant deterministic generator: seeded from ``(seed, scenario
    name, tenant index, stream)`` via SeedSequence, so adding a tenant or a
    stream never perturbs the draws of the others."""
    return np.random.default_rng([seed, _salt(scenario), tenant_index,
                                  stream])


def shared_prefix_tokens(seed: int, scenario: str, tenant_index: int,
                         group: int, length: int,
                         vocab_size: int) -> list[int]:
    """The shared prefix for one ``(tenant, group)``: deterministic in the
    trace seed, disjoint RNG stream from arrivals/lengths (stream
    ``1000 + group``)."""
    rng = tenant_rng(seed, scenario, tenant_index, stream=1000 + group)
    return [int(t) for t in rng.integers(2, max(vocab_size - 1, 3),
                                         size=length)]


def _chat() -> Scenario:
    return Scenario(
        name="chat",
        description="interactive chat + background batch tenant; Poisson "
                    "arrivals, moderate prompts, lognormal generations, "
                    "shared system prompts",
        tenants=(
            TenantSpec("interactive",
                       ArrivalProcess("poisson", rate=8.0),
                       prompt_len=Dist("uniform", 32, 192),
                       new_tokens=Dist("lognormal", 96, 320, sigma=0.6),
                       shared_prefix_len=64, prefix_groups=4,
                       slo_ttft_s=0.5, slo_tpot_s=0.05),
            TenantSpec("batch",
                       ArrivalProcess("poisson", rate=2.0),
                       prompt_len=Dist("uniform", 64, 384),
                       new_tokens=Dist("uniform", 64, 256),
                       slo_ttft_s=2.0, slo_tpot_s=0.10),
        ))


def _rag() -> Scenario:
    return Scenario(
        name="rag",
        description="RAG long-prefill: fat retrieval-stuffed prompts with a "
                    "shared template prefix, short grounded answers",
        tenants=(
            TenantSpec("rag",
                       ArrivalProcess("poisson", rate=4.0),
                       prompt_len=Dist("uniform", 512, 1280),
                       new_tokens=Dist("uniform", 32, 128),
                       shared_prefix_len=256, prefix_groups=8,
                       slo_ttft_s=2.0, slo_tpot_s=0.08),
            TenantSpec("control",
                       ArrivalProcess("poisson", rate=1.0),
                       prompt_len=Dist("uniform", 16, 64),
                       new_tokens=Dist("uniform", 16, 64),
                       slo_ttft_s=0.5, slo_tpot_s=0.05),
        ))


def _agentic() -> Scenario:
    return Scenario(
        name="agentic",
        description="agent tool loops: gamma-burst arrivals (cv≈3) resending "
                    "conversation state as a shared prefix, plus a trickle "
                    "of long background jobs",
        tenants=(
            TenantSpec("agent",
                       ArrivalProcess("gamma_burst", rate=6.0, cv=3.0),
                       prompt_len=Dist("uniform", 48, 256),
                       new_tokens=Dist("uniform", 16, 96),
                       shared_prefix_len=128, prefix_groups=2,
                       slo_ttft_s=0.4, slo_tpot_s=0.05),
            TenantSpec("background",
                       ArrivalProcess("fixed", rate=0.5),
                       prompt_len=Dist("uniform", 64, 256),
                       new_tokens=Dist("uniform", 128, 384),
                       slo_ttft_s=4.0, slo_tpot_s=0.15),
        ))


def _code() -> Scenario:
    return Scenario(
        name="code",
        description="code completion: high-rate bursty short generations "
                    "with tight TTFT, plus an assistant-chat tenant",
        tenants=(
            TenantSpec("completion",
                       ArrivalProcess("gamma_burst", rate=20.0, cv=2.0),
                       prompt_len=Dist("uniform", 96, 384),
                       new_tokens=Dist("choice", choices=(4, 8, 12, 16, 24)),
                       shared_prefix_len=64, prefix_groups=6,
                       slo_ttft_s=0.2, slo_tpot_s=0.03),
            TenantSpec("assistant",
                       ArrivalProcess("poisson", rate=1.5),
                       prompt_len=Dist("uniform", 48, 192),
                       new_tokens=Dist("uniform", 32, 128),
                       slo_ttft_s=1.0, slo_tpot_s=0.08),
        ))


#: the named-scenario registry (factories so a caller can never mutate the
#: canonical definitions)
SCENARIOS: dict[str, object] = {
    "chat": _chat, "rag": _rag, "agentic": _agentic, "code": _code,
}


def get_scenario(name: str) -> Scenario:
    try:
        return SCENARIOS[name]()  # type: ignore[operator]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; available: "
                       f"{sorted(SCENARIOS)}") from None
