"""Unified ternary-matmul dispatch: one entry point, several kernels.

The port's registry holds the reference's dense registry, in its order:

  * ``ref``: plain PyTorch, unpack then an f32 matmul (the oracle, and the
    fastest CPU path);
  * ``lut_onehot`` / ``lut_gather``: the paper's two-phase LUT with the
    signed one-hot or the gather fetch, hand-written CUDA
    (``kernels/lut_matmul.py``);
  * ``dequant_packed``: the dequant baseline on base-3 bytes, hand-written
    CUDA (``kernels/dequant_matmul.py``);
  * ``signflip``: the sign-flip baseline on int8 trits, hand-written CUDA
    (``kernels/signflip_matmul.py``);
  * ``w2a8``: exact int8 × trit → int32, int8 activations only, hand-written
    CUDA (``kernels/w2a8_matmul.py``);
  * ``tl2``: the two-trit 9-entry LUT, hand-written CUDA
    (``kernels/tl2_matmul.py``);
  * ``tl2_ref``: the plain PyTorch TL2 product (``tl2_matmul_torch``);

and its grouped (MoE expert stack) registry, for problems keyed by an
expert count ``e`` (dense and grouped kernels are never eligible for each
other's problems):

  * ``grouped_ref``: plain PyTorch, each expert's bytes decoded to f32
    right before its matmul (the grouped oracle);
  * ``grouped_dequant`` / ``grouped_w2a8``: hand-written CUDA with an
    expert grid dimension (``kernels/grouped_matmul.py``);
  * ``grouped_tl2``: the plain TL2 product, expert by expert.

Selection follows the reference exactly: an autotune cache keyed on
``(E, M, K, N, mu, act_dtype, backend)`` when it has a measurement
(:func:`autotune` takes them), else the analytical static prior (per-MAC
gate cost from the paper's area model plus the weight bytes streamed), ties
broken by name.  The prior's penalty for a kernel that cannot run natively
here becomes: a hand-written kernel whose tensors are not on CUDA.  On
``cuda`` the prior therefore picks what the reference picks on its
accelerator backend.

Shape convention: ``x [..., K]``, weights ``[N, K]`` (out-major), result
``[..., N]``; grouped: ``x [E, C, K]``, weights ``[E, N, K]``, result
``[E, C, N]``.  Kernels return the *unscaled* product in f32; the weight
scale (per expert for grouped weights) is applied once on the way out.
"""

from __future__ import annotations

import json
import math
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from repro_torch.core import cost_model as cm
from repro_torch.core import encoding
from repro_torch.device import resolve_device
from repro_torch.kernels.dequant_matmul import packed_matmul
from repro_torch.kernels.grouped_matmul import (grouped_packed_matmul,
                                                grouped_packed_matmul_torch,
                                                grouped_w2a8_matmul)
from repro_torch.kernels.lut_matmul import lut_matmul, lut_onehot_matmul
from repro_torch.kernels.signflip_matmul import signflip_matmul
from repro_torch.kernels.tl2_matmul import ROW_BYTES as TL2_ROW_BYTES
from repro_torch.kernels.tl2_matmul import (TRITS_PER_WORD, pack_tl2,
                                            repack_base3_to_tl2, tl2_matmul,
                                            tl2_matmul_torch)
from repro_torch.kernels.tl2_matmul import ZERO_WORD as TL2_ZERO_WORD
from repro_torch.kernels.w2a8_matmul import w2a8_matmul

CACHE_PATH_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"

#: exchange rate between the prior's two terms: gate-cycles of compute per
#: byte of weight traffic (the reference's constant)
GATES_PER_BYTE = 2048.0

#: multiplier on hand-written kernels whose tensors are not on CUDA (they
#: would run their plain PyTorch version, which is never competitive)
OFF_DEVICE_PENALTY = 1e4


# ---------------------------------------------------------------------------
# Weight container
# ---------------------------------------------------------------------------


class TernaryWeight:
    """A ternary ``[N, K]`` weight (out-major) with its absmean ``scale``.

    Built from base-3 packed bytes (the serving artifact) or int8 trits.
    Each kernel's encoding (dense trits, base-3 bytes, mu-group LUT keys,
    TL2 words) is derived once, on first use, on the weight's device, and
    kept: a weight bound once serves every later step without re-deriving
    it.
    """

    def __init__(self, w_t: torch.Tensor | None = None, scale=1.0, *,
                 packed: torch.Tensor | None = None, k: int | None = None,
                 mu: int = 3):
        if w_t is None and packed is None:
            raise ValueError("need trits or packed bytes")
        if w_t is not None and w_t.dtype != torch.int8:
            w_t = w_t.to(torch.int8)
        self._w_t = w_t
        self._packed = packed
        self._k = int(w_t.shape[-1]) if w_t is not None else int(k)
        self.scale = scale
        self.mu = mu
        self._keys: dict[int, torch.Tensor] = {}
        self._tl2: torch.Tensor | None = None

    @classmethod
    def from_ternary(cls, w_t: torch.Tensor, scale=1.0, *,
                     mu: int = 3) -> "TernaryWeight":
        return cls(w_t, scale, mu=mu)

    @classmethod
    def from_packed(cls, packed: torch.Tensor, scale, k: int, *,
                    mu: int = 3) -> "TernaryWeight":
        """Serving artifact ``{"packed" [N, ceil(K/5)+pad], "scale"}``."""
        return cls(None, scale, packed=packed, k=k, mu=mu)

    @property
    def out_features(self) -> int:
        src = self._w_t if self._w_t is not None else self._packed
        return int(src.shape[0])

    @property
    def in_features(self) -> int:
        return self._k

    def _trits_uncached(self) -> torch.Tensor:
        if self._w_t is not None:
            return self._w_t
        return encoding.unpack_base3(self._packed, self._k)

    def trits(self) -> torch.Tensor:
        """Dense ``[N, K]`` int8 trits (ref/signflip paths)."""
        if self._w_t is None:
            self._w_t = self._trits_uncached()
        return self._w_t

    def packed(self) -> torch.Tensor:
        """Base-3 packed bytes ``[N, ceil(K/5)]`` (dequant/w2a8 paths)."""
        if self._packed is None:
            self._packed = encoding.pack_base3(self._w_t)
        return self._packed

    def keys(self, mu: int | None = None) -> torch.Tensor:
        """Group keys ``[N, ceil(K/mu)]`` (LUT path): one view, kept, of
        rows padded to :data:`encoding.KEY_ROW_BYTES` with the zero key,
        which the LUT kernel reads in place."""
        mu = mu or self.mu
        if mu not in self._keys:
            keys = encoding.encode_weight_matrix(self._trits_uncached(), mu)
            self._keys[mu] = encoding.pad_rows(
                keys, encoding.KEY_ROW_BYTES,
                encoding.table_size(mu))[:, :keys.shape[1]]
        return self._keys[mu]

    def tl2(self) -> torch.Tensor:
        """TL2 words ``[N, ceil(K/10)]`` held as int16 (tl2 path): one
        view, kept, of rows padded to :data:`tl2_matmul.ROW_BYTES` with the
        word of ten zero trits, which the tl2 kernel reads in place."""
        if self._tl2 is None:
            words = (repack_base3_to_tl2(self._packed, self._k)
                     if self._w_t is None else pack_tl2(self._w_t))
            self._tl2 = encoding.pad_rows(
                words, TL2_ROW_BYTES, TL2_ZERO_WORD)[:, :words.shape[1]]
        return self._tl2


class GroupedTernaryWeight:
    """A stacked per-expert ternary weight ``[E, N, K]`` with per-expert
    absmean scales ``[E]``: the MoE counterpart of :class:`TernaryWeight`.

    The serving artifact is ``{"packed": uint8 [E, N, ceil(K/5)+pad],
    "scale": [E]}``.  The packed bytes and, once derived, the TL2 words are
    kept; the dense ``[E, N, K]`` trit stack never is (at phi3.5-moe's width
    it is 1.26 G trits a layer): :meth:`trits` decodes it anew on each call,
    and the kernels decode tile by tile or expert by expert.
    """

    def __init__(self, w_t: torch.Tensor | None = None, scale=1.0, *,
                 packed: torch.Tensor | None = None, k: int | None = None,
                 mu: int = 3):
        if w_t is None and packed is None:
            raise ValueError("need trits or packed bytes")
        src = w_t if w_t is not None else packed
        if src.ndim != 3:
            raise ValueError(f"grouped weights are stacked [E, N, K] trits / "
                             f"[E, N, ceil(K/5)] bytes; got ndim {src.ndim}")
        self._k = int(w_t.shape[-1]) if w_t is not None else int(k)
        self._packed = (packed if w_t is None
                        else encoding.pack_base3(w_t.to(torch.int8)))
        self.scale = scale
        self.mu = mu
        self._tl2: torch.Tensor | None = None

    @classmethod
    def from_ternary(cls, w_t: torch.Tensor, scale=1.0, *,
                     mu: int = 3) -> "GroupedTernaryWeight":
        return cls(w_t, scale, mu=mu)

    @classmethod
    def from_packed(cls, packed: torch.Tensor, scale, k: int, *,
                    mu: int = 3) -> "GroupedTernaryWeight":
        """Serving artifact ``{"packed" [E, N, ceil(K/5)+pad], "scale" [E]}``."""
        return cls(None, scale, packed=packed, k=k, mu=mu)

    @property
    def n_experts(self) -> int:
        return int(self._packed.shape[0])

    @property
    def out_features(self) -> int:
        return int(self._packed.shape[1])

    @property
    def in_features(self) -> int:
        return self._k

    def packed(self) -> torch.Tensor:
        """Stacked base-3 packed bytes ``[E, N, ceil(K/5)(+pad)]``."""
        return self._packed

    def trits(self) -> torch.Tensor:
        """Dense stacked ``[E, N, K]`` int8 trits, decoded anew on every call
        (never kept)."""
        return encoding.unpack_base3(self._packed, self._k)

    def tl2(self) -> torch.Tensor:
        """Stacked TL2 words ``[E, N, ceil(K/10)]`` held as int16, derived
        once, expert by expert (one expert's trits live at a time)."""
        if self._tl2 is None:
            self._tl2 = torch.stack([repack_base3_to_tl2(p, self._k)
                                     for p in self._packed])
        return self._tl2


# ---------------------------------------------------------------------------
# Kernel registry
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class KernelSpec:
    """One registered ternary-matmul implementation.

    Dense kernels: ``run(x2, w, mu)`` takes ``x2 [M, K]`` and returns the
    unscaled ``[M, N]`` f32 product against ``w``'s trits.  Grouped kernels
    (``grouped=True``): ``run(x3, gw, mu)`` takes ``x3 [E, C, K]`` against
    a :class:`GroupedTernaryWeight` and returns the unscaled ``[E, C, N]``
    f32 product; a grouped problem is keyed by its expert count ``e``."""

    name: str
    run: Callable
    act_dtypes: frozenset
    #: the hand-written CUDA kernel's wrapper (its ``launches`` counts its
    #: launches); None for the plain PyTorch entries
    kernel: Callable | None
    prior_per_mac: Callable           # (K, N, coeffs, mu) -> gates per MAC
    weight_bytes: Callable            # (K, N, mu) -> weight bytes streamed
    describe: str = ""
    constraint: Callable | None = None  # (M, K, N, act_dtype) -> bool
    grouped: bool = False             # batched-expert (MoE) kernel
    #: the dense kernel's grouped counterpart (``fixed:<dense>`` pins map
    #: through it on MoE problems)
    grouped_variant: str | None = None

    @property
    def hand(self) -> bool:
        return self.kernel is not None

    def supports(self, m: int, k: int, n: int, act_dtype: str,
                 e: int | None = None) -> bool:
        if (e is not None) != self.grouped:
            return False
        if act_dtype not in self.act_dtypes:
            return False
        return self.constraint is None or self.constraint(m, k, n, act_dtype)


REGISTRY: dict[str, KernelSpec] = {}

_ALL_DTYPES = frozenset({"float32", "bfloat16", "float16", "int8"})


def register_kernel(spec: KernelSpec) -> KernelSpec:
    if spec.name in REGISTRY:
        raise ValueError(f"kernel {spec.name!r} already registered")
    REGISTRY[spec.name] = spec
    return spec


def get_kernel(name: str) -> KernelSpec:
    if name not in REGISTRY:
        raise KeyError(f"unknown kernel {name!r}; registered: {sorted(REGISTRY)}")
    return REGISTRY[name]


def eligible_kernels(m: int, k: int, n: int, act_dtype: str,
                     e: int | None = None) -> list[KernelSpec]:
    return [s for s in REGISTRY.values() if s.supports(m, k, n, act_dtype, e)]


def launch_counts() -> dict[str, int]:
    """Launches of each hand kernel, by registry name, since its count was
    last set to 0."""
    return {s.name: s.kernel.launches for s in REGISTRY.values() if s.hand}


def reset_launch_counts() -> None:
    for s in REGISTRY.values():
        if s.hand:
            s.kernel.launches = 0


def _run_ref(x2, w, mu):
    return x2.to(torch.float32) @ w.trits().to(torch.float32).T


def _run_lut(kernel):
    # x of the logical width K: the kernels take the last group short
    def run(x2, w, mu):
        return kernel(x2, w.keys(mu), mu)

    return run


def _run_dequant(x2, w, mu):
    return packed_matmul(x2, w.packed(), w.in_features)


def _run_signflip(x2, w, mu):
    return signflip_matmul(x2, w.trits())


def _run_w2a8(x2, w, mu):
    return w2a8_matmul(x2, w.packed(), w.in_features).to(torch.float32)


def _run_tl2(x2, w, mu):
    return tl2_matmul(x2, w.tl2(), w.in_features)


def _run_tl2_ref(x2, w, mu):
    return tl2_matmul_torch(x2, w.tl2(), w.in_features)


def _run_grouped_ref(x3, w, mu):
    # expert by expert: the bytes decoded straight to f32 right before each
    # expert's matmul (one expert's dense [N, K] live at a time, nothing
    # kept), the plain version of grouped_dequant
    return grouped_packed_matmul_torch(x3, w.packed(), w.in_features)


def _run_grouped_dequant(x3, w, mu):
    return grouped_packed_matmul(x3, w.packed(), w.in_features)


def _run_grouped_w2a8(x3, w, mu):
    return grouped_w2a8_matmul(x3, w.packed(), w.in_features).to(
        torch.float32)


def _run_grouped_tl2(x3, w, mu):
    # expert by expert, as grouped_ref: one expert's pair tables and
    # one-hot fetch operand live at a time
    k = w.in_features
    return torch.stack([tl2_matmul_torch(x3[e], we, k)
                        for e, we in enumerate(w.tl2())])


def _per_mac_lut(k, n, c, mu):
    return cm.area_per_throughput(mu, max(k, mu), max(n, 1), c)


def _per_mac_dequant(k, n, c, mu):
    return cm.area_gates_dequant_baseline(k, n, c) / max(k * n, 1)


def _per_mac_signflip(k, n, c, mu):
    return cm.area_gates_signflip_baseline(k, n, c) / max(k * n, 1)


def _per_mac_tl2(k, n, c, mu):
    # TL2 is the mu=2 point of the LUT family: a trit pair keys 9 entries
    return cm.area_per_throughput(2, max(k, 2), max(n, 1), c)


def _per_mac_dense(k, n, c, mu):
    return c.a_mul + c.a_add


def _bytes_dense(k, n, mu):
    return 2.0 * k * n          # bf16 dense weights


def _bytes_trits(k, n, mu):
    return float(k * n)         # int8 trit stream (signflip)


def _bytes_packed(k, n, mu):
    return n * math.ceil(k / encoding.TRITS_PER_BYTE)   # 1.6 b/w base-3


def _bytes_keys(k, n, mu):
    nbytes = 1 if encoding.key_bits(mu) <= 8 else 2
    return n * math.ceil(k / mu) * nbytes


def _bytes_tl2(k, n, mu):
    return 2.0 * n * math.ceil(k / TRITS_PER_WORD)


def _bytes_tl2_onehot_f32(k, n, mu):
    # the plain TL2 product materializes the decoded [N, ceil(K/2), 9] f32
    # one-hot through memory; the reference charges that stream, so the
    # prior never picks it over a kernel on the card
    return 4.0 * 9.0 * n * math.ceil(k / 2)


register_kernel(KernelSpec(
    name="ref", run=_run_ref, act_dtypes=_ALL_DTYPES, kernel=None,
    prior_per_mac=_per_mac_dense, weight_bytes=_bytes_dense,
    grouped_variant="grouped_ref",
    describe="plain PyTorch f32 matmul over decoded trits (oracle + CPU "
             "serving path)"))

register_kernel(KernelSpec(
    name="lut_onehot", run=_run_lut(lut_onehot_matmul),
    act_dtypes=_ALL_DTYPES, kernel=lut_onehot_matmul,
    prior_per_mac=_per_mac_lut, weight_bytes=_bytes_keys,
    describe="two-phase LUT CUDA kernel, shared-memory tables, signed "
             "one-hot fetch contraction",
    constraint=lambda m, k, n, d: True))

register_kernel(KernelSpec(
    name="lut_gather", run=_run_lut(lut_matmul), act_dtypes=_ALL_DTYPES,
    kernel=lut_matmul, prior_per_mac=_per_mac_lut, weight_bytes=_bytes_keys,
    describe="two-phase LUT CUDA kernel, shared-memory tables, gather fetch",
    constraint=lambda m, k, n, d: True))

register_kernel(KernelSpec(
    name="dequant_packed", run=_run_dequant, act_dtypes=_ALL_DTYPES,
    kernel=packed_matmul, prior_per_mac=_per_mac_dequant,
    weight_bytes=_bytes_packed, grouped_variant="grouped_dequant",
    describe="base-3 packed dequant CUDA kernel (1.6 b/w, trits decoded "
             "into bf16 tensor-core fragments, f32 sums)"))

register_kernel(KernelSpec(
    name="signflip", run=_run_signflip, act_dtypes=_ALL_DTYPES,
    kernel=signflip_matmul, prior_per_mac=_per_mac_signflip,
    weight_bytes=_bytes_trits,
    describe="sign-flip baseline CUDA kernel: int8 trits select add, "
             "subtract or skip (Fig. 1 middle)"))

register_kernel(KernelSpec(
    name="w2a8", run=_run_w2a8, act_dtypes=frozenset({"int8"}),
    kernel=w2a8_matmul, prior_per_mac=_per_mac_dequant,
    weight_bytes=_bytes_packed, grouped_variant="grouped_w2a8",
    describe="W1.58A8 exact int8 x trit -> int32 CUDA kernel (int8 tensor "
             "cores); requires pre-quantized int8 activations"))

register_kernel(KernelSpec(
    name="tl2", run=_run_tl2, act_dtypes=_ALL_DTYPES, kernel=tl2_matmul,
    prior_per_mac=_per_mac_tl2, weight_bytes=_bytes_tl2,
    grouped_variant="grouped_tl2",
    describe="TL2 two-trit 9-entry LUT CUDA kernel (base-9 16-bit words, "
             "1.6 b/w)"))

register_kernel(KernelSpec(
    name="tl2_ref", run=_run_tl2_ref, act_dtypes=_ALL_DTYPES, kernel=None,
    prior_per_mac=_per_mac_tl2, weight_bytes=_bytes_tl2_onehot_f32,
    grouped_variant="grouped_tl2",
    describe="plain PyTorch TL2 product: pair tables + one-hot fetch "
             "contraction over base-9 words"))


def _bytes_decoded_f32(k, n, mu):
    # grouped_ref streams the packed bytes and round-trips a decoded f32
    # tile per expert through memory; the reference charges the decoded
    # stream, so in-kernel decode wins the bandwidth-bound decode regime
    return 4.0 * k * n


register_kernel(KernelSpec(
    name="grouped_ref", run=_run_grouped_ref, act_dtypes=_ALL_DTYPES,
    kernel=None, grouped=True, prior_per_mac=_per_mac_dense,
    weight_bytes=_bytes_decoded_f32,
    describe="plain PyTorch batched-expert matmul: each expert's bytes "
             "decoded to f32 right before its matmul (grouped oracle + CPU "
             "MoE serving path; no [E, N, K] dense intermediate)"))

register_kernel(KernelSpec(
    name="grouped_dequant", run=_run_grouped_dequant, act_dtypes=_ALL_DTYPES,
    kernel=grouped_packed_matmul, grouped=True,
    prior_per_mac=_per_mac_dequant, weight_bytes=_bytes_packed,
    describe="grouped base-3 packed dequant CUDA kernel: expert grid "
             "dimension, bytes decoded straight into bf16 tensor-core "
             "fragments (1.6 b/w MoE path)"))

register_kernel(KernelSpec(
    name="grouped_w2a8", run=_run_grouped_w2a8,
    act_dtypes=frozenset({"int8"}), kernel=grouped_w2a8_matmul, grouped=True,
    prior_per_mac=_per_mac_dequant, weight_bytes=_bytes_packed,
    describe="grouped W1.58A8 exact int8 x trit -> int32 CUDA kernel (s8 "
             "tensor cores) with an expert grid dimension"))

register_kernel(KernelSpec(
    name="grouped_tl2", run=_run_grouped_tl2, act_dtypes=_ALL_DTYPES,
    kernel=None, grouped=True, prior_per_mac=_per_mac_tl2,
    weight_bytes=_bytes_tl2_onehot_f32,
    describe="grouped TL2: the plain TL2 product expert by expert over the "
             "stacked base-9 words (no dense [E, N, K] intermediate)"))


# ---------------------------------------------------------------------------
# Static prior
# ---------------------------------------------------------------------------


def static_prior(spec: KernelSpec, m: int, k: int, n: int, act_dtype: str,
                 device: str = "cuda", mu: int = 3,
                 e: int | None = None) -> float:
    """Analytical cost of ``spec`` on an ``[m,k]×[n,k]`` matmul: per-MAC
    gate cost × MACs plus :data:`GATES_PER_BYTE` × weight bytes.  Lower is
    better.  A grouped problem passes its expert count ``e`` (``m`` is then
    the per-expert capacity) and both terms scale by ``e``: every expert's
    weights stream every step.  Hand-written kernels carry
    :data:`OFF_DEVICE_PENALTY` when the tensors are not on CUDA."""
    coeffs = cm.get_coeffs("int8" if act_dtype == "int8" else "fp16")
    compute = float(m) * k * n * spec.prior_per_mac(k, n, coeffs, mu)
    cost = (compute + GATES_PER_BYTE * spec.weight_bytes(k, n, mu)) \
        * (e if e is not None else 1)
    if spec.hand and device != "cuda":
        cost *= OFF_DEVICE_PENALTY
    return cost


# ---------------------------------------------------------------------------
# Autotune cache
# ---------------------------------------------------------------------------


def _default_cache_path() -> str:
    return os.environ.get(
        CACHE_PATH_ENV,
        os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                     "autotune.json"))


#: on-disk schema (the reference's v2 key form); other versions load empty
CACHE_SCHEMA_VERSION = 2


@dataclass
class AutotuneCache:
    """Disk-persisted measurements ``(M,K,N,mu,dtype,backend) → {kernel: µs}``,
    grouped problems keyed with their expert count prepended (``M`` is then
    the per-expert capacity)::

        {"schema_version": 2,
         "entries": {"M4:K2560:N6912:mu3:bfloat16:cuda": {"lut_gather": 41.0},
                     "E16:M1:K4096:N6400:mu3:bfloat16:cuda": {...}}}
    """

    path: str = field(default_factory=_default_cache_path)
    entries: dict = field(default_factory=dict)

    @staticmethod
    def key(m: int, k: int, n: int, act_dtype: str, backend: str, *,
            mu: int = 3, e: int | None = None) -> str:
        prefix = f"E{e}:" if e is not None else ""
        return f"{prefix}M{m}:K{k}:N{n}:mu{mu}:{act_dtype}:{backend}"

    @classmethod
    def load(cls, path: str | None = None) -> "AutotuneCache":
        path = path or _default_cache_path()
        entries = {}
        try:
            with open(path) as fh:
                doc = json.load(fh)
            if isinstance(doc, dict) and \
                    doc.get("schema_version") == CACHE_SCHEMA_VERSION:
                entries = doc.get("entries", {})
        except (OSError, ValueError):
            pass
        return cls(path=path, entries=entries)

    def save(self) -> None:
        """Atomically persist: a unique temp file in the target directory,
        fsync, then ``os.replace`` (readers never see a partial file)."""
        d = os.path.dirname(self.path) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".autotune-", suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as fh:
                json.dump({"schema_version": CACHE_SCHEMA_VERSION,
                           "entries": self.entries}, fh, indent=1,
                          sort_keys=True)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def record(self, m: int, k: int, n: int, act_dtype: str, backend: str,
               kernel: str, us: float, *, mu: int = 3,
               e: int | None = None) -> None:
        key = self.key(m, k, n, act_dtype, backend, mu=mu, e=e)
        self.entries.setdefault(key, {})[kernel] = us
        _SELECTED.clear()

    def best(self, m: int, k: int, n: int, act_dtype: str, backend: str, *,
             mu: int = 3, e: int | None = None) -> str | None:
        t = self.entries.get(
            self.key(m, k, n, act_dtype, backend, mu=mu, e=e), {})
        t = {name: us for name, us in t.items() if name in REGISTRY}
        return min(t, key=t.get) if t else None


_CACHE: AutotuneCache | None = None

#: selections made against the process cache, keyed on the whole problem
#: ``(m, k, n, act_dtype, policy, device, mu, e)``: a decode step asks for
#: the same few shapes on every projection, so each is resolved once
_SELECTED: dict[tuple, "KernelSpec"] = {}


def get_autotune_cache() -> AutotuneCache:
    """The process's autotune cache, read from disk once."""
    global _CACHE
    if _CACHE is None:
        _CACHE = AutotuneCache.load()
    return _CACHE


def reset_autotune_cache() -> None:
    """Drop the in-process cache and the selections made against it
    (re-reads the path on next use)."""
    global _CACHE
    _CACHE = None
    _SELECTED.clear()


# ---------------------------------------------------------------------------
# Selection + public entry point
# ---------------------------------------------------------------------------


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def select_kernel(m: int, k: int, n: int, act_dtype: str, *,
                  policy: str | None = None, device: str = "cuda",
                  cache: AutotuneCache | None = None,
                  mu: int = 3, e: int | None = None) -> KernelSpec:
    """Resolve a policy to a registered kernel for the given problem.

    ``"fixed:<name>"`` pins a kernel (``KeyError`` listing the registered
    kernels if unknown); ``"auto"`` (the default, ``policy=None``) takes the
    autotune cache's best when it has one, else the prior; ``"prior"``
    ignores the cache.  Grouped (MoE expert) problems pass ``e``, the expert
    count, with ``m`` the per-expert capacity; only grouped kernels are then
    eligible, and a ``fixed:<dense>`` pin resolves through the dense
    kernel's ``grouped_variant`` (``ref`` → ``grouped_ref`` etc.), so one
    policy governs a whole model; a dense kernel without one (the LUT and
    sign-flip paths) raises on a grouped problem.  Without an explicit
    ``cache`` the result is memoized per problem until the process cache
    changes."""
    policy = policy or "auto"
    if cache is not None:
        return _select(m, k, n, act_dtype, policy, device, cache, mu, e)
    key = (m, k, n, act_dtype, policy, device, mu, e)
    spec = _SELECTED.get(key)
    if spec is None:
        spec = _SELECTED[key] = _select(m, k, n, act_dtype, policy, device,
                                        None, mu, e)
    return spec


def _select(m: int, k: int, n: int, act_dtype: str, policy: str, device: str,
            cache: AutotuneCache | None, mu: int,
            e: int | None) -> KernelSpec:
    if policy.startswith("fixed:"):
        spec = get_kernel(policy[len("fixed:"):])
        if e is not None and not spec.grouped:
            if spec.grouped_variant is None:
                raise ValueError(
                    f"kernel {spec.name!r} has no grouped (batched-expert) "
                    f"variant; MoE expert matmuls cannot honour policy "
                    f"'fixed:{spec.name}'. Pin one of "
                    f"{sorted(s.name for s in REGISTRY.values() if s.grouped)}"
                    f" or a dense kernel with a grouped counterpart "
                    f"{sorted(s.name for s in REGISTRY.values() if s.grouped_variant)}")
            spec = get_kernel(spec.grouped_variant)
        if not spec.supports(m, k, n, act_dtype, e):
            raise ValueError(f"kernel {spec.name!r} does not support "
                             f"act_dtype={act_dtype} at M={m} K={k} N={n} "
                             f"E={e} (grouped={spec.grouped})")
        return spec
    if policy not in ("auto", "prior"):
        raise ValueError(
            f"unknown policy {policy!r}; expected 'auto', 'prior', or "
            f"'fixed:<name>' with name in {sorted(REGISTRY)}")
    candidates = eligible_kernels(m, k, n, act_dtype, e)
    if not candidates:
        raise ValueError(f"no registered kernel supports act_dtype="
                         f"{act_dtype} at M={m} K={k} N={n} E={e}")
    if policy == "auto":
        cache = cache or get_autotune_cache()
        best = cache.best(m, k, n, act_dtype, device, mu=mu, e=e)
        if best is not None and \
                get_kernel(best).supports(m, k, n, act_dtype, e):
            return get_kernel(best)
    return min(candidates,
               key=lambda s: (static_prior(s, m, k, n, act_dtype, device, mu,
                                           e),
                              s.name))


def ternary_matmul(x: torch.Tensor, w: TernaryWeight, *, scale=None,
                   policy: str | None = None, mu: int | None = None,
                   cache: AutotuneCache | None = None) -> torch.Tensor:
    """``y[..., n] = Σ_k x[..., k] · trits(w)[n, k] · scale`` through the
    kernel selected for this (shape, dtype, device).

    ``x`` is float (f32/bf16/f16) or pre-quantized int8 (the caller applies
    the activation scale).  Returns ``[..., N]`` in ``x``'s dtype for float
    inputs, f32 for int8."""
    mu = mu or w.mu
    lead = x.shape[:-1]
    k = x.shape[-1]
    if k != w.in_features:
        raise ValueError(f"x K={k} != weight K={w.in_features}")
    x2 = x.reshape(-1, k)
    n = w.out_features
    act = _dtype_name(x.dtype)
    spec = select_kernel(x2.shape[0], k, n, act, policy=policy,
                         device=x.device.type, cache=cache, mu=mu)
    y = spec.run(x2, w, mu)
    s = w.scale if scale is None else scale
    if s is not None:
        y = y * torch.as_tensor(s, dtype=torch.float32, device=y.device)
    out_dtype = torch.float32 if act == "int8" else x.dtype
    return y.reshape(*lead, n).to(out_dtype)


def grouped_ternary_matmul(x: torch.Tensor, w: GroupedTernaryWeight, *,
                           scale=None, policy: str | None = None,
                           mu: int | None = None,
                           cache: AutotuneCache | None = None) -> torch.Tensor:
    """``y[e, ..., n] = Σ_k x[e, ..., k] · trits(w)[e, n, k] · scale[e]``,
    the batched-expert (MoE) entry point, through the grouped kernel
    selected for ``(E, C, K, N, dtype, device)``.

    ``x`` is ``[E, ..., K]`` per-expert rows (the MoE dispatch buffer
    ``[E, C, K]``), float or pre-quantized int8; ``scale`` overrides ``w``'s
    per-expert scale ``[E]`` (a rank-1 factor applied once in f32).
    Returns ``[E, ..., N]`` in ``x``'s dtype for float inputs, f32 for
    int8."""
    mu = mu or w.mu
    E = w.n_experts
    if x.ndim < 2 or x.shape[0] != E:
        raise ValueError(f"grouped activations must be [E, ..., K] with "
                         f"E={E}; got shape {tuple(x.shape)}")
    lead = x.shape[1:-1]
    k = x.shape[-1]
    if k != w.in_features:
        raise ValueError(f"x K={k} != weight K={w.in_features}")
    n = w.out_features
    x3 = x.reshape(E, -1, k)
    act = _dtype_name(x.dtype)
    spec = select_kernel(x3.shape[1], k, n, act, policy=policy,
                         device=x.device.type, cache=cache, mu=mu, e=E)
    y = spec.run(x3, w, mu)
    s = w.scale if scale is None else scale
    if s is not None:
        s = torch.as_tensor(s, dtype=torch.float32, device=y.device)
        y = y * (s.reshape(E, 1, 1) if s.ndim else s)
    out_dtype = torch.float32 if act == "int8" else x.dtype
    return y.reshape(E, *lead, n).to(out_dtype)


# ---------------------------------------------------------------------------
# Autotuning
# ---------------------------------------------------------------------------


#: bytes read to flush the L2 before each timed call on the card: more than
#: twice the H100's 50 MB L2, so each call reads its weights from HBM as a
#: decode step does (one layer's weights are a few MB; a step streams all
#: 30 layers'), and a read, unlike a write, leaves no dirty lines for the
#: timed call to write back
FLUSH_BYTES = 128 << 20
#: device cycles a second, to size the sleep that queues a timed series (the
#: H100 SXM's SM clock tops out near 2 GHz, so a sleep of this many cycles
#: lasts at least a second)
SLEEP_CYCLES_PER_S = 2e9


def cold_times_ms(fn: Callable[[], object], reps: int,
                  flush: torch.Tensor) -> list[float]:
    """Device time (ms) of each of ``reps`` calls of ``fn()`` on the card,
    each from a cold L2, as a decode step finds each layer's weights.
    Before every call the L2 is flushed by reading ``flush`` (a CUDA
    buffer of :data:`FLUSH_BYTES`), and the series is queued behind a
    device sleep longer than its enqueue takes, so the window between a
    call's two events holds the call's device time only: no write-back of
    the flush, no host work of ``fn``'s wrapper."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flush.sum()
    fn()
    host_s = time.perf_counter() - t0
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda.synchronize()
    torch.cuda._sleep(int(SLEEP_CYCLES_PER_S * (2 * reps * host_s + 1e-3)))
    for start, end in events:
        flush.sum()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return [start.elapsed_time(end) for start, end in events]


def _time_us(fn: Callable[[], torch.Tensor], reps: int,
             device: torch.device, flush: torch.Tensor | None) -> float:
    """Median time of ``fn()`` in µs over ``reps`` calls: on the card each
    call's device time from a cold L2 (:func:`cold_times_ms`, flushing
    with ``flush``); on the CPU, the host clock around each call after one
    warm call."""
    if device.type == "cuda":
        return float(np.median(cold_times_ms(fn, reps, flush))) * 1e3
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    return float(np.median(times))


def autotune(m: int, k: int, n: int, act_dtype: str = "float32", *,
             kernels: list[str] | None = None, reps: int = 20, seed: int = 0,
             backend: str | None = None, cache: AutotuneCache | None = None,
             save: bool = True, mu: int = 3,
             device: str | torch.device | None = None,
             e: int | None = None) -> dict[str, float]:
    """Time every eligible kernel (or those named in ``kernels``) on an
    ``[m,k]×[n,k]`` problem on ``device`` (default ``cuda``) and record the
    times (µs) in the autotune cache under ``backend`` (default: the
    device's type), so later ``policy="auto"`` dispatches of the same
    ``(M, K, N, mu, act_dtype, backend)`` take the measured best.  Pass
    ``e`` to time a grouped (MoE expert) problem: ``m`` is then the
    per-expert capacity, the operands are stacked ``[e, m, k]`` and
    ``[e, n, ceil(k/5)]``, and only grouped kernels run.  Returns
    ``{kernel_name: µs}``.

    Inputs are made from ``seed``: int8 or normal activations, a random
    base-3 packed weight with the serving artifact's rows padded to a
    multiple of 128 bytes, so each kernel reads the weight laid out as it
    does in serving (the trits' rows then start 16-byte aligned, as the
    ``signflip`` kernel needs; unpadded, it would time the wrapper's copy
    too).  Four deliberate differences from the reference's ``autotune``:

    * the clock starts after each kernel's weight encoding (trits, bytes,
      keys or words) is derived: the port's serving path derives it once per
      bound weight (:class:`TernaryWeight`, :class:`GroupedTernaryWeight`),
      where the reference derives it inside the jitted step and so times it
      too;
    * a kernel that raises is not skipped with a warning: the error
      propagates, so a hand kernel that fails to build or launch on the
      card stops the run instead of dropping out of the measurements;
    * on the card a time is the median of ``reps`` (default 20) single-call
      device times, each from a cold L2 and without host launch gaps
      (:func:`cold_times_ms`), where the reference divides the wall time
      of 3 back-to-back calls by 3: close winners then flip less with the
      host's noise;
    * the weight is laid out as served (above), where the reference packs
      it unpadded."""
    if reps < 1:
        raise ValueError(f"reps must be >= 1, got {reps}")
    dev = resolve_device(device)
    backend = backend or dev.type
    if backend != dev.type:
        # a time taken here, recorded under another backend's key, would
        # steer that backend's auto dispatch
        raise ValueError(f"autotune measures on {dev.type!r}; cannot record "
                         f"for backend={backend!r}")
    cache = cache or get_autotune_cache()
    rng = np.random.default_rng(seed)
    lead = () if e is None else (e,)
    if act_dtype == "int8":
        x = torch.from_numpy(rng.integers(-127, 128, size=(*lead, m, k),
                                          dtype=np.int8))
    else:
        x = torch.from_numpy(rng.normal(size=(*lead, m, k))).to(
            getattr(torch, act_dtype))
    trits = torch.from_numpy(rng.integers(-1, 2, size=(*lead, n, k),
                                          dtype=np.int8))
    x = x.to(dev)
    packed = encoding.pad_rows(encoding.pack_base3(trits.to(dev)),
                               encoding.PACKED_ROW_BYTES)
    del trits
    w = (TernaryWeight if e is None else GroupedTernaryWeight).from_packed(
        packed, 1.0, k, mu=mu)
    names = kernels or [s.name for s in eligible_kernels(m, k, n, act_dtype, e)]
    flush = (torch.zeros(FLUSH_BYTES, dtype=torch.uint8, device=dev)
             if dev.type == "cuda" else None)
    results: dict[str, float] = {}
    for name in names:
        spec = get_kernel(name)
        if not spec.supports(m, k, n, act_dtype, e):
            continue
        results[name] = _time_us(lambda run=spec.run: run(x, w, mu), reps, dev,
                                 flush)
        cache.record(m, k, n, act_dtype, backend, name, results[name], mu=mu,
                     e=e)
    if save and results:
        cache.save()
    return results
