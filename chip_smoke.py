#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the eight hand-written CUDA kernels from
``src/repro_torch/kernels/csrc`` (``lut_gather``, ``lut_onehot``, ``tl2``,
``dequant_packed``, ``w2a8``, ``signflip``, ``grouped_dequant``,
``grouped_w2a8``; one ``nvcc`` per source, all at once), then serves two
models at full width, each built layer by layer from a seed
(``decode.init_serving_params``; the bf16 tree is never held):

bitnet-b1.58-2b (30 layers, d_model 2560), through ``DecodeEngine`` under
``ContinuousScheduler``, on these paths:

  * on the analytical prior, with an empty autotune cache: batch 4 (the
    main path, ``lut_gather``), batch 1 and int8 activations (``tl2``);
  * autotuned: ``DecodeEngine.autotune_shapes`` times every eligible kernel
    at the engine's shapes (bf16 and int8, batch 4; twice, to show how far
    the winners repeat), then batch 4 serves under ``auto`` on those
    measurements, once with bf16 and once with int8 activations;
  * pinned: ``fixed:lut_onehot``, ``fixed:dequant_packed``,
    ``fixed:signflip`` (bf16) and ``fixed:w2a8`` (int8), batch 4;

then, with bitnet's tree freed, phi3.5-moe-42b-a6.6b (32 layers, d_model
4096, 16 experts top-2, d_ff 6400, an MoE FFN on every layer) on these:

  * ``moe_batch4``: the prior on the empty cache, bf16, batch 4 (attention
    on ``lut_gather``, every expert stack on ``grouped_dequant``: 3 launches
    per layer per step);
  * ``moe_int8_w2a8``: ``fixed:w2a8`` with int8 activations, batch 4
    (``w2a8`` and ``grouped_w2a8``);
  * ``moe_autotuned``: ``autotune_shapes`` at bf16 (dense and grouped
    shapes), then batch 4 under ``auto``.

The kernel phase of each model checks every (kernel, M or capacity C,
activation dtype) that dispatch selects on any of its paths, decode and
prefill alike, at the model's shapes (the autotuned paths' selections are
checked once they are known), and each path asserts that what it selected
was checked.  Every serving path is driven with the kernels' launch
counters set to 0 just before it and read just after; each kernel the path
selects must have launched, and no other.  After each path the prefill
logits of one prompt through its kernels are held against the plain
``ref`` path (``grouped_ref`` on the experts) on the card.

Each phase prints one JSON line; a fuller record goes to
``smoke_out/chip_smoke.json``.  The last two lines are the kernel summary
and ``{"ok": true, "device": {...}}``.  Any failure ends the process with a
nonzero exit and no result line; so does a machine without a CUDA card.

Tolerances:
  * kernel vs plain, float inputs: both accumulate in f32 in different
    orders, so they agree to a few f32 ulps of the row's absolute sum:
    atol = 1e-5 * max_b sum_k |x[b, k]|.  int8 inputs: every partial sum is an
    integer below 2^24, so the results must be equal.
    ``w2a8`` and ``grouped_w2a8`` sum in int32 and must equal the plain
    version (and ``w2a8`` the int64 product).
  * prefill logits, kernels vs ``ref``: the two differ only in the f32
    summation order inside each projection; where that flips a bf16 rounding
    of an activation the change is one bf16 ulp, and through 30 residual
    layers the logits (magnitude < 8) move by a few bf16 ulps at most:
    atol = 2^-3, four ulps at magnitude 4 to 8.  With int8 activations
    every kernel sums the same integers exactly (int32, or f32 below 2^24)
    and the same scales follow, so every int8 path (prior, autotuned,
    ``fixed:w2a8``, ``moe_int8_w2a8``) must equal ``fixed:ref`` exactly
    (atol 0).
  * MoE: the top-2 routing is discontinuous in the hidden state, so a
    one-ulp difference can send a token to another expert and move the
    logits by more than any summation-order tolerance.  Each MoE path is
    therefore also held sub-layer by sub-layer with the reference's own
    input fed to both (so both take the same routing): each attention and
    MoE output within 2^-5 of its largest magnitude (a few bf16 roundings
    of each projection's output, eight ulps at the top binade; a wrong
    kernel is off by the order of the output itself), exactly at int8.
    The full-model logits are recorded with the number of tokens whose
    experts differ; ``moe_batch4`` and ``moe_int8_w2a8`` are held to 2^-3
    and 0 there as the dense paths are, and ``moe_autotuned`` only where
    no token was rerouted.  ``moe_batch4`` and ``moe_autotuned`` are also
    run with each layer's top-2 experts teacher-forced to ``fixed:ref``'s
    (gates from the path's own router), and those logits are held to 2^-3
    of ``fixed:ref``'s: a bound on the kernels over the whole model with
    the routing noise taken out.

Timing: each kernel, its plain version and the library yardstick are timed
call by call from a cold L2 by the timer autotune uses
(``dispatch.cold_times_ms``): a read of 128 MB before every call, the calls
queued behind a device sleep so each event pair holds device time only.  A
``kernel`` row keeps each series' mean (``ms``, ``plain_ms``,
``library_ms``) and beside it the median, minimum and maximum
(``ms_median``, ``ms_min``, ``ms_max``, and the same for the other two;
autotune ranks by the median); a ``layer`` row sums the means and the
medians over one layer.
"""

from __future__ import annotations

import functools
import json
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "smoke_out")
SEED = 0
ARCH = "bitnet-b1.58-2b"
MOE_ARCH = "phi3.5-moe-42b-a6.6b"
#: per model, (K, N) of its dense ternary projections and how many of each
#: one layer has: bitnet wq, wo (attention) | wk, wv | wg, wi | down (the
#: FFN's wo); phi3.5-moe wq, wo | wk, wv (its FFN is the MoE)
LAYER_KN = {ARCH: {(2560, 2560): 2, (2560, 640): 2, (2560, 6912): 2,
                   (6912, 2560): 1},
            MOE_ARCH: {(4096, 4096): 2, (4096, 1024): 2}}
#: per model, (E, K, N) of its expert stacks and how many one layer has:
#: wi, wg | wo
LAYER_EKN = {ARCH: {}, MOE_ARCH: {(16, 4096, 6400): 2, (16, 6400, 4096): 1}}
#: H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
INT8_OPS_PER_S = 1979e12
#: shared memory returns 128 bytes a clock an SM (times the SMs and the
#: SM clock read in the run: the ceiling of lut_gather's table reads)
SMEM_BYTES_PER_CLOCK = 128
LOGIT_ATOL = 2.0 ** -3
#: sub-layer outputs with the same input, kernels vs ``ref``, relative to
#: the output's largest magnitude (see the module docstring)
LAYER_RTOL = 2.0 ** -5
DEVICE = "cuda"
#: admission prefill chunk of every serving path (the M of prefill matmuls)
PREFILL_CHUNK = 32
#: serving paths on the prior: name -> (model, decode batch, activation
#: dtype, policy)
PATHS = {"batch4": (ARCH, 4, "bfloat16", None),
         "batch1": (ARCH, 1, "bfloat16", None),
         "int8": (ARCH, 4, "int8", None),
         "moe_batch4": (MOE_ARCH, 4, "bfloat16", None),
         "moe_int8_w2a8": (MOE_ARCH, 4, "int8", "fixed:w2a8")}
#: bitnet's pinned paths (batch 4): name -> (policy, activation dtype)
PINNED = {"lut_onehot": ("fixed:lut_onehot", "bfloat16"),
          "dequant_packed": ("fixed:dequant_packed", "bfloat16"),
          "signflip": ("fixed:signflip", "bfloat16"),
          "w2a8": ("fixed:w2a8", "int8")}
#: every hand kernel: name -> (CUDA source, the TPU kernel it replaces, the
#: model, M (capacity C for a grouped kernel) and act its summary in the
#: kernels line is taken at)
SOURCES = {
    "lut_gather": ("src/repro_torch/kernels/csrc/lut_matmul.cu",
                   "src/repro/kernels/lut_matmul.py:96", ARCH, 4, "bfloat16"),
    "lut_onehot": ("src/repro_torch/kernels/csrc/lut_matmul.cu",
                   "src/repro/kernels/lut_matmul.py:96", ARCH, 4, "bfloat16"),
    "tl2": ("src/repro_torch/kernels/csrc/tl2_matmul.cu",
            "src/repro/kernels/tl2_matmul.py:176", ARCH, 1, "bfloat16"),
    "dequant_packed": ("src/repro_torch/kernels/csrc/packed_matmul.cu",
                       "src/repro/kernels/dequant_matmul.py:59", ARCH, 4,
                       "bfloat16"),
    "w2a8": ("src/repro_torch/kernels/csrc/packed_matmul.cu",
             "src/repro/kernels/w2a8_matmul.py:50", ARCH, 4, "int8"),
    "signflip": ("src/repro_torch/kernels/csrc/signflip_matmul.cu",
                 "src/repro/kernels/signflip_matmul.py:48", ARCH, 4,
                 "bfloat16"),
    "grouped_dequant": ("src/repro_torch/kernels/csrc/grouped_matmul.cu",
                        "src/repro/kernels/grouped_matmul.py:112", MOE_ARCH,
                        1, "bfloat16"),
    "grouped_w2a8": ("src/repro_torch/kernels/csrc/grouped_matmul.cu",
                     "src/repro/kernels/grouped_matmul.py:143", MOE_ARCH, 1,
                     "int8"),
}
HAND_KERNELS = tuple(SOURCES)
GROUPED_KERNELS = ("grouped_dequant", "grouped_w2a8")
#: the CUDA sources, one nvcc each
CUDA_SOURCES = ["lut_matmul", "tl2_matmul", "packed_matmul", "signflip_matmul",
                "grouped_matmul"]
#: the kernels whose per-layer times chip_smoke sets side by side (the
#: packed kernels and tl2 at int8 beside signflip, which does the same MMAs
#: on 5x the bytes), at decode and prefill; and tl2 at bf16 batch-1 and
#: batch-2 decode
LAYER_ROWS = [(name, m, act) for m in (4, PREFILL_CHUNK)
              for name, act in (("dequant_packed", "bfloat16"),
                                ("w2a8", "int8"), ("tl2", "int8"),
                                ("signflip", "bfloat16"))] + \
    [("tl2", m, "bfloat16") for m in (1, 2)]
#: the grouped kernels' per-layer rows (phi3.5-moe's three expert stacks),
#: at the capacities of a batch-4 decode step and of an admission chunk
MOE_LAYER_ROWS = [(name, m, act) for name, act in (("grouped_dequant",
                                                     "bfloat16"),
                                                    ("grouped_w2a8", "int8"))
                  for m in (4, PREFILL_CHUNK)]

RECORD: dict = {}


def emit(phase: str, **fields) -> None:
    RECORD.setdefault("phases", []).append({"phase": phase, **fields})
    print(json.dumps({"phase": phase, **fields}), flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0]


@functools.lru_cache(maxsize=None)
def sm_clocks_mhz() -> tuple[float, float]:
    """The card's SM clock now and its maximum, in MHz, as nvidia-smi reads
    them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"], check=True, capture_output=True,
        text=True)
    now, top = out.stdout.strip().splitlines()[0].split(",")
    return float(now), float(top)


def smem_bytes_per_s(torch) -> float:
    """Shared memory's peak rate over the card: 128 bytes a clock an SM at
    the maximum SM clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return SMEM_BYTES_PER_CLOCK * sms * sm_clocks_mhz()[1] * 1e6


# ---------------------------------------------------------------------------
# per-kernel check and timing
# ---------------------------------------------------------------------------


def kernel_case(torch, name: str, m: int, k: int, n: int, act: str, flush,
                e: int | None = None):
    """Check one hand kernel against its plain version at one shape and
    time both and the library yardstick.  A grouped kernel takes ``e``
    experts of ``m`` rows (the capacity).  ``flush``: the buffer read to
    flush the L2."""
    from repro_torch.core import encoding
    from repro_torch.kernels import dequant_matmul as deq
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels import lut_matmul as lut
    from repro_torch.kernels import signflip_matmul as sf
    from repro_torch.kernels import tl2_matmul as tl2
    from repro_torch.kernels import w2a8_matmul as w8
    from repro_torch.kernels.dispatch import TernaryWeight, cold_times_ms

    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(SEED + 7 * m + k + n)
    lead = () if e is None else (e,)
    if act == "int8":
        x = torch.randint(-127, 128, (*lead, m, k), generator=g, device=dev,
                          dtype=torch.int8)
    else:
        x = torch.randn((*lead, m, k), generator=g, device=dev,
                        dtype=torch.bfloat16)
    trits = torch.randint(-1, 2, (*lead, n, k), generator=g, device=dev,
                          dtype=torch.int8)
    # base-3 bytes with the serving artifact's row padding
    packed = encoding.pad_rows(encoding.pack_base3(trits),
                               encoding.PACKED_ROW_BYTES)
    rate = F32_OPS_PER_S
    experts = e or 1
    packed_bytes = experts * n * -(-k // encoding.TRITS_PER_BYTE)
    # ``ops`` is the function's floor on this weight encoding, not what the
    # kernel's design spends: one add per trit, key or pair and row, plus
    # the table build where the encoding needs one
    if name in GROUPED_KERNELS:
        fn, plain_fn = ((gm.grouped_packed_matmul,
                         gm.grouped_packed_matmul_torch)
                        if name == "grouped_dequant" else
                        (gm.grouped_w2a8_matmul, gm.grouped_w2a8_matmul_torch))
        kernel = lambda: fn(x, packed, k)                       # noqa: E731
        plain = lambda: plain_fn(x, packed, k)                  # noqa: E731
        wbytes = packed_bytes     # every expert streams; padding never read
        ops = e * m * n * k
        # the adds run on the tensor cores: s8 for grouped_w2a8, else bf16
        rate = INT8_OPS_PER_S if name == "grouped_w2a8" else BF16_OPS_PER_S
    else:
        w = TernaryWeight.from_packed(packed, 1.0, k)
        mu = w.mu
    ceiling = None
    if name in ("lut_gather", "lut_onehot"):
        # as served: x of the logical width, the weight's keys view (rows
        # padded to 16 bytes), neither copied
        keys = w.keys()
        G = keys.shape[1]
        onehot = name == "lut_onehot"
        fn, plain_fn = ((lut.lut_onehot_matmul, lut.lut_onehot_matmul_torch)
                        if onehot else
                        (lut.lut_matmul, lut.lut_matmul_torch))
        kernel = lambda: fn(x, keys, mu)                        # noqa: E731
        plain = lambda: plain_fn(x, keys, mu)                   # noqa: E731
        wbytes = n * G * keys.element_size()
        # whichever fetch computes it: the table build, then one add per
        # key and row
        ops = m * G * encoding.table_size(mu) + m * n * G
        if onehot:
            # the adds run on the bf16 tensor cores; the design's ceiling:
            # one m16n8k16 MMA (4096 flops) per group, 16 columns and 8
            # (row, bf16 term) slots, 3 terms a row, at the peak rate
            rate = BF16_OPS_PER_S
            mmas = -(-n // 16) * G * -(-3 * m // 8)
            ceiling = ("tensor cores", mmas * 4096 / BF16_OPS_PER_S * 1e3)
        else:
            # the design's ceiling: one 4-byte table read per key and row
            ceiling = ("shared memory",
                       4 * m * n * G / smem_bytes_per_s(torch) * 1e3)
    elif name == "tl2":
        # as served: x of the logical width, the weight's words view (rows
        # padded to 16 bytes), neither copied
        words = w.tl2()
        fn = tl2.tl2_matmul
        kernel = lambda: fn(x, words, k)                        # noqa: E731
        plain = lambda: tl2.tl2_matmul_torch(x, words, k)       # noqa: E731
        wbytes = words.numel() * words.element_size()   # padding never read
        ops = m * n * k
        # the adds run on the tensor cores: s8 for int8 x, else bf16
        rate = INT8_OPS_PER_S if act == "int8" else BF16_OPS_PER_S
    elif name == "dequant_packed":
        fn = deq.packed_matmul
        kernel = lambda: fn(x, packed, k)                       # noqa: E731
        plain = lambda: deq.packed_matmul_torch(x, packed, k)   # noqa: E731
        wbytes = packed_bytes                # the padding is never read
        ops = m * n * k
        rate = BF16_OPS_PER_S       # the adds run on the bf16 tensor cores
    elif name == "w2a8":
        fn = w8.w2a8_matmul
        kernel = lambda: fn(x, packed, k)                       # noqa: E731
        plain = lambda: w8.w2a8_matmul_torch(x, packed, k)      # noqa: E731
        wbytes = packed_bytes
        ops = m * n * k
        rate = INT8_OPS_PER_S
    elif name == "signflip":
        wt = w.trits()
        kernel = lambda: sf.signflip_matmul(x, wt)              # noqa: E731
        plain = lambda: sf.signflip_matmul_torch(x, wt)         # noqa: E731
        wbytes = wt.numel()
        ops = m * n * k
        rate = BF16_OPS_PER_S       # the adds run on the bf16 tensor cores
    elif name not in GROUPED_KERNELS:
        raise KeyError(name)
    wd = trits.to(torch.bfloat16).transpose(-1, -2)     # decoded [.., K, N]
    xb = x.to(torch.bfloat16)
    # the yardstick: one bf16 product on decoded weights (never in the port)
    library = ((lambda: torch.bmm(xb, wd)) if e is not None   # noqa: E731
               else (lambda: torch.matmul(xb, wd)))          # noqa: E731

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err = float((got.double() - want.double()).abs().max())
    if act == "int8":
        exact = torch.equal(got, want)
        if e is None:
            exact = exact and torch.equal(
                got.cpu().to(torch.int64),
                x.cpu().to(torch.int64) @ trits.cpu().to(torch.int64).T)
        tol = 0.0
        if not exact:
            raise AssertionError(f"{name} int8 E={e} M={m} K={k} N={n}: not "
                                 f"exact (max abs err {err})")
    else:
        tol = 1e-5 * float(x.double().abs().sum(-1).max()) + 1e-6
        if not err <= tol:
            raise AssertionError(f"{name} E={e} M={m} K={k} N={n}: max abs "
                                 f"err {err} > {tol}")
    nbytes = x.numel() * x.element_size() + wbytes + experts * m * n * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3

    row = {"kernel": name, "E": e, "M": m, "K": k, "N": n, "act": act,
           "max_abs_err": err, "tol": tol,
           **series_ms("ms", cold_times_ms(kernel, 20, flush)),
           **series_ms("plain_ms", cold_times_ms(plain, 5, flush)),
           **series_ms("library_ms", cold_times_ms(library, 20, flush)),
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": nbytes, "ops": ops, "ops_per_s": rate}
    if ceiling is not None:
        row["ceiling_by"], row["ceiling_ms"] = ceiling
    if name != "signflip":
        row["grid"] = fn.last_grid
    return row


def series_ms(key: str, times: list[float]) -> dict:
    """A timed series as ``key`` (its mean) and ``key_median``,
    ``key_min`` and ``key_max``."""
    return {key: statistics.fmean(times),
            f"{key}_median": statistics.median(times),
            f"{key}_min": min(times), f"{key}_max": max(times)}


def capacity(model: str, m: int) -> int:
    """The per-expert capacity of a forward over ``m`` tokens."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.layers import moe_capacity

    return moe_capacity(get_config(model), m)


def path_selection(model: str, batch: int, act: str,
                   policy: str | None = None) -> dict:
    """What dispatch selects on one serving path of ``model``: ``{shape:
    kernel}`` for its decode M (the batch) and its prefill M (the chunk);
    a dense shape is ``(M, K, N)``, a grouped one ``(E, C, K, N)``."""
    from repro_torch.kernels.dispatch import select_kernel

    sel = {}
    for m in (batch, PREFILL_CHUNK):
        for k, n in LAYER_KN[model]:
            sel[(m, k, n)] = select_kernel(m, k, n, act, policy=policy).name
        for e, k, n in LAYER_EKN[model]:
            c = capacity(model, m)
            sel[(e, c, k, n)] = select_kernel(c, k, n, act, policy=policy,
                                              e=e).name
    return sel


def selected_cases(model: str, selection: dict, act: str) -> set:
    """The ``(model, kernel, M or C, act)`` of the hand kernels in a path
    selection."""
    return {(model, name, shape[-3], act)
            for shape, name in selection.items() if name in HAND_KERNELS}


def kernel_cases(model: str) -> list[tuple]:
    """``(model, kernel, M or C, act)`` to check before serving ``model``:
    bitnet's decode points at batch 4, 1, 2 and int8 batch 4 (``tl2`` at
    int8 also at the prefill chunk, M=32), each dense
    kernel ported after the first slice at decode (M=4) and prefill (M=32);
    phi3.5-moe's grouped kernels at decode (C=1) and at the admission chunk
    (C=5); plus every one that a prior or pinned serving path selects."""
    if model == ARCH:
        cases = {(ARCH, "lut_gather", 4, "bfloat16"),
                 (ARCH, "lut_gather", 32, "bfloat16"),
                 (ARCH, "lut_onehot", 4, "bfloat16"),
                 (ARCH, "lut_onehot", 32, "bfloat16"),
                 (ARCH, "tl2", 1, "bfloat16"), (ARCH, "tl2", 2, "bfloat16"),
                 (ARCH, "tl2", 4, "int8"), (ARCH, "tl2", 32, "int8")}
        for policy, act in PINNED.values():
            cases |= selected_cases(ARCH, path_selection(ARCH, 4, act,
                                                         policy), act)
    else:
        cases = {(model, name, capacity(model, m), act)
                 for name, act in (("grouped_dequant", "bfloat16"),
                                   ("grouped_w2a8", "int8"))
                 for m in (4, PREFILL_CHUNK)}
    for mdl, batch, act, policy in PATHS.values():
        if mdl == model:
            cases |= selected_cases(model, path_selection(model, batch, act,
                                                          policy), act)
    return sorted(cases)


def check_kernels(torch, cases, flush) -> list[dict]:
    rows = []
    for model, name, m, act in cases:
        if name in GROUPED_KERNELS:
            shapes = [(e, k, n) for e, k, n in LAYER_EKN[model]]
        else:
            shapes = [(None, k, n) for k, n in LAYER_KN[model]]
        for e, k, n in shapes:
            row = kernel_case(torch, name, m, k, n, act, flush, e=e)
            row["model"] = model
            emit("kernel", **row)
            rows.append(row)
    return rows


def layer_summary(rows: list[dict], name: str, model: str, m: int,
                  act: str) -> dict:
    """One kernel's numbers for one layer of ``model`` at the main path's
    M or C: the sums over the layer's projections (or expert stacks) of
    the per-shape times."""
    grouped = name in GROUPED_KERNELS
    counts = ({(k, n): c for (_, k, n), c in LAYER_EKN[model].items()}
              if grouped else LAYER_KN[model])
    sel = {(r["K"], r["N"]): r for r in rows
           if r["kernel"] == name and r["M"] == m and r["act"] == act
           and r["model"] == model}
    keys = ["ms", "plain_ms", "library_ms", "ms_median", "plain_ms_median",
            "library_ms_median"]
    tot = {key: sum(sel[kn][key] * c for kn, c in counts.items())
           for key in keys}
    t_bytes = sum(sel[kn]["bytes"] * c for kn, c in counts.items()) \
        / HBM_BYTES_PER_S * 1e3
    t_ops = sum(sel[kn]["ops"] / sel[kn]["ops_per_s"] * c
                for kn, c in counts.items()) * 1e3
    what = ("3 expert stacks (wi, wg, wo)" if grouped else
            f"{sum(counts.values())} projections")
    return {**tot, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "max_abs_err": max(r["max_abs_err"] for r in rows
                               if r["kernel"] == name),
            "at": f"{model}, {'C' if grouped else 'M'}={m} {act}, sum over "
                  f"one layer's {what}"}


def lut_ceilings(rows: list[dict]) -> list[dict]:
    """The LUT kernels' design ceilings (their source note's) for one
    bitnet layer at each M they were timed at, beside the layer's time:
    the sums over the layer's projections."""
    out = []
    for name in ("lut_gather", "lut_onehot"):
        for m in sorted({r["M"] for r in rows if r["kernel"] == name}):
            sel = {(r["K"], r["N"]): r for r in rows
                   if r["kernel"] == name and r["M"] == m
                   and r["act"] == "bfloat16" and r["model"] == ARCH}
            if set(sel) != set(LAYER_KN[ARCH]):
                continue
            tot = {key: sum(sel[kn][key] * c
                            for kn, c in LAYER_KN[ARCH].items())
                   for key in ("ms", "library_ms", "ceiling_ms")}
            out.append({"kernel": name, "M": m, **tot,
                        "ceiling_by": next(iter(sel.values()))["ceiling_by"],
                        "sm_clock_max_mhz": sm_clocks_mhz()[1]})
    return out


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def make_requests(lengths, new_tokens: int, vocab: int, seed: int):
    import numpy as np

    from repro_torch.serving.engine import Request

    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(2, vocab, size=n).tolist(),
                    max_new_tokens=new_tokens) for n in lengths]


def serve_path(torch, served, cfg, model: str, *, batch: int, lengths,
               new_tokens: int, checked: set) -> dict:
    """Serve one path (``cfg.matmul_policy``) and return its record.  A
    one-request warm-up first derives the kernels' weight encodings (set-up,
    untimed); then the counters are set to 0, the requests are served, and
    the counters read.  Every hand kernel the path selects must be in
    ``checked`` and must have launched; no other hand kernel may have."""
    from repro_torch.kernels.dispatch import (launch_counts,
                                              reset_launch_counts)
    from repro_torch.serving.engine import DecodeEngine
    from repro_torch.serving.scheduler import ContinuousScheduler

    act = "int8" if cfg.act_dtype == "int8" else cfg.dtype
    selection = path_selection(model, batch, act, cfg.matmul_policy)
    cases = selected_cases(model, selection, act)
    expect = {name for _, name, _, _ in cases}
    unchecked = sorted(cases - checked)
    if unchecked:
        raise AssertionError(f"path selects kernels the kernel phase did not "
                             f"check: {unchecked}")
    engine = DecodeEngine(served, cfg, batch_size=batch, max_len=256,
                          prefill_chunk=PREFILL_CHUNK, device=DEVICE)
    if engine.prefill_chunk != PREFILL_CHUNK:
        raise AssertionError(f"prefill chunk {engine.prefill_chunk} != "
                             f"{PREFILL_CHUNK}")
    engine.serve(make_requests([lengths[0]], 2, cfg.vocab_size, SEED + 99))
    torch.cuda.synchronize()
    reqs = make_requests(lengths, new_tokens, cfg.vocab_size, SEED + batch)
    sched = ContinuousScheduler(engine)
    for r in reqs:
        sched.submit(r)
    reset_launch_counts()
    t0 = time.perf_counter()
    sched.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    for r in reqs:
        if not (r.done and len(r.out) == new_tokens) or \
                not all(0 <= t < cfg.vocab_size for t in r.out):
            raise AssertionError(f"request {r.rid} ended with {r.out} "
                                 f"(done={r.done})")
    wrong = {name: c for name, c in counts.items()
             if (c > 0) != (name in expect)}
    if wrong:
        raise AssertionError(f"launches {counts} disagree with the path's "
                             f"selected hand kernels {sorted(expect)}")
    selected = {":".join(f"{d}{v}" for d, v in zip(
        "EMKN" if len(shape) == 4 else "MKN", shape)): name
        for shape, name in selection.items()}
    n_tok = sum(len(r.out) for r in reqs)
    step_ms, step_launches = decode_step_ms(torch, engine, cfg)
    del engine
    return {"model": model, "policy": cfg.matmul_policy or "auto",
            "act": act, "batch": batch, "requests": len(reqs),
            "prompt_lengths": lengths, "new_tokens": n_tok,
            "decode_steps": sched.stats.decode_steps,
            "prefill_chunks": sched.stats.prefill_chunks,
            "seconds": dt, "tokens_per_s": n_tok / dt,
            "decode_step_ms": step_ms,
            "launches_per_decode_step": step_launches, "launches": counts,
            "selected": selected}


def decode_step_ms(torch, engine, cfg, steps: int = 10):
    """Wall time of one decode step with every slot live, and each hand
    kernel's launches per step (after the path's counters were read):
    admit one request per slot, warm up, time ``steps`` scheduler steps
    ending in a synchronize."""
    from repro_torch.kernels.dispatch import (launch_counts,
                                              reset_launch_counts)

    state = engine.sched_start()
    for slot, r in enumerate(make_requests([8] * engine.B, steps + 4,
                                           cfg.vocab_size, SEED + 3)):
        state = engine.sched_admit(state, slot, r)
    for _ in range(2):
        state, _, _ = engine.sched_step(state)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, _, _ = engine.sched_step(state)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / steps * 1e3
    return ms, {k: v / steps for k, v in launch_counts().items() if v}


def _prompt_chunks(torch, vocab: int):
    """The cross-check prompt (45 tokens) as admission runs it: ``(tokens
    [1, chunk], positions [1, chunk], take)`` per chunk."""
    import numpy as np

    from repro_torch.models.decode import prefill_chunks_of

    prompt = np.random.default_rng(SEED + 5).integers(2, vocab, size=45)
    for start, valid in prefill_chunks_of(len(prompt), PREFILL_CHUNK):
        toks = torch.ones((1, PREFILL_CHUNK), dtype=torch.int64, device=DEVICE)
        toks[0, :valid] = torch.from_numpy(prompt[start:start + valid])
        pos = torch.full((1, PREFILL_CHUNK), -1, dtype=torch.int32,
                         device=DEVICE)
        pos[0, :valid] = torch.arange(start, start + valid, dtype=torch.int32)
        yield toks, pos, valid - 1


def _prefill_logits(torch, served, cfg):
    """The cross-check prompt's last-token logits after prefill under
    ``cfg``, chunk by chunk as admission runs it."""
    from repro_torch.models.decode import (bind_serving_weights, init_cache,
                                           prefill_chunk)

    p = bind_serving_weights(served, cfg)
    cache = init_cache(cfg, 1, 256, device=DEVICE)
    for toks, pos, take in _prompt_chunks(torch, cfg.vocab_size):
        cache, out = prefill_chunk(p, cfg, cache, toks, pos, take)
    return out[0, :cfg.vocab_size].float()


def forced_check(torch, served, cfg) -> dict:
    """Prefill logits of the cross-check prompt through the path's kernels
    (``cfg.matmul_policy``) with every MoE layer call's top-k experts
    teacher-forced to those ``fixed:ref`` takes, against ``fixed:ref``:
    within ``LOGIT_ATOL`` (0 with int8 activations).  The path keeps its
    own router: the forced experts' gates are its own probabilities at
    them, renormalized as ``route`` does.  With routing noise forced out,
    this bounds the kernels' error over the whole model."""
    from repro_torch.models import layers

    path = cfg.matmul_policy or "auto"
    atol = 0.0 if cfg.act_dtype == "int8" else LOGIT_ATOL
    route = layers.route
    choices = []

    def recording(router, xf, c):
        probs, vals, idx = route(router, xf, c)
        choices.append(idx)
        return probs, vals, idx

    def forced(router, xf, c):
        probs = route(router, xf, c)[0]
        idx = next(replay)
        vals = probs.gather(-1, idx)
        return probs, vals / torch.clamp(vals.sum(-1, keepdim=True), 1e-9), idx

    try:
        layers.route = recording
        ref = _prefill_logits(torch, served,
                              cfg.with_(matmul_policy="fixed:ref"))
        replay = iter(choices)
        layers.route = forced
        kern = _prefill_logits(torch, served, cfg)
    finally:
        layers.route = route
    if next(replay, None) is not None or not choices:
        raise AssertionError(f"{path}: the forced run made other MoE calls "
                             f"than the {len(choices)} recorded")
    if not (torch.isfinite(kern).all() and torch.isfinite(ref).all()):
        raise AssertionError("non-finite prefill logits")
    diff = float((kern - ref).abs().max())
    if not diff <= atol:
        raise AssertionError(f"teacher-forced prefill logits: {path} vs ref "
                             f"max abs diff {diff} > {atol}")
    return {"arch": cfg.name, "policy": path, "act_dtype": cfg.act_dtype,
            "max_abs_diff": diff, "atol": atol,
            "forced_moe_calls": len(choices),
            "argmax_equal": bool(kern.argmax() == ref.argmax())}


def cross_check(torch, served, cfg, *, routing_may_differ=False) -> dict:
    """Prefill logits of one prompt through the path's kernels
    (``cfg.matmul_policy``) and through ``fixed:ref``, chunk by chunk as
    admission runs it, at ``cfg``'s activation dtype: within ``LOGIT_ATOL``
    with float activations, equal with int8 ones.

    For an MoE model the top-k experts each token takes in each layer are
    recorded on both runs.  With ``routing_may_differ`` a path whose
    routing differs from the reference's somewhere is not held to
    ``LOGIT_ATOL``: a token sent to another expert changes its output by
    that expert's whole contribution, which no summation-order tolerance
    covers; its sub-layers are held to the reference by
    :func:`layer_check` instead, and the difference is reported."""
    from repro_torch.models import model as model_mod
    from repro_torch.models.layers import route

    path = cfg.matmul_policy or "auto"
    atol = 0.0 if cfg.act_dtype == "int8" else LOGIT_ATOL
    logits, routes = {}, {}
    moe_ffn = model_mod.moe_ffn

    def recording(p, x, c):
        routes[c.matmul_policy].append(
            route(p["router"], x.reshape(-1, x.shape[-1]), c)[2].sort(-1)[0])
        return moe_ffn(p, x, c)

    model_mod.moe_ffn = recording
    try:
        for policy in (path, "fixed:ref"):
            routes[policy] = []
            logits[policy] = _prefill_logits(
                torch, served, cfg.with_(matmul_policy=policy))
    finally:
        model_mod.moe_ffn = moe_ffn
    # (layer call, token) rows whose top-k expert set differs
    rerouted = sum(int((a != b).any(-1).sum())
                   for a, b in zip(routes[path], routes["fixed:ref"]))
    kern, ref = logits[path], logits["fixed:ref"]
    if not (torch.isfinite(kern).all() and torch.isfinite(ref).all()):
        raise AssertionError("non-finite prefill logits")
    diff = float((kern - ref).abs().max())
    held = not (routing_may_differ and rerouted)
    if held and not diff <= atol:
        raise AssertionError(f"prefill logits: {path} vs ref max abs diff "
                             f"{diff} > {atol} (tokens rerouted: "
                             f"{rerouted})")
    return {"arch": cfg.name, "policy": path,
            "act_dtype": cfg.act_dtype, "max_abs_diff": diff, "atol": atol,
            "held_to_atol": held, "rerouted_tokens": rerouted,
            "routed_tokens": sum(int(a.shape[0]) for a in routes[path]),
            "max_abs_logit": float(ref.abs().max()),
            "argmax_equal": bool(kern.argmax() == ref.argmax())}


def layer_check(torch, served, cfg) -> dict:
    """The cross-check prompt's first chunk through the stack with every
    sub-layer (attention, MoE FFN) of the path fed the reference's own
    input, so both take the same routing: each sub-layer's output through
    the path's kernels within ``LAYER_RTOL`` of its largest magnitude of
    the ``fixed:ref`` output (equal with int8 activations), and the final
    logits from the reference's last hidden state likewise."""
    from repro_torch.models.decode import bind_serving_weights, cache_len
    from repro_torch.models.layers import append_attention, rms_norm
    from repro_torch.models.model import block_ffn, embed_tokens, layer_blocks

    path = cfg.matmul_policy or "auto"
    cp, cr = cfg, cfg.with_(matmul_policy="fixed:ref")
    blocks = zip(layer_blocks(bind_serving_weights(served, cp)),
                 layer_blocks(bind_serving_weights(served, cr)))
    rtol = 0.0 if cfg.act_dtype == "int8" else LAYER_RTOL
    toks, pos, _ = next(_prompt_chunks(torch, cfg.vocab_size))
    CL = cache_len(cfg, 256)
    empty = torch.zeros((1, CL, cfg.n_kv_heads, cfg.head_dim),
                        dtype=torch.bfloat16, device=DEVICE)
    no_pos = torch.full((1, CL), -1, dtype=torch.int32, device=DEVICE)
    h = embed_tokens(served, cfg, toks)
    worst = 0.0

    def held(got, want, what):
        nonlocal worst
        err = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        worst = max(worst, err / scale)
        if not err <= rtol * scale:
            raise AssertionError(f"{path} {what}: max abs err {err} > "
                                 f"{rtol} * {scale}")

    for i, (bp, br) in enumerate(blocks):
        hn = rms_norm(br["ln1"], h, offset=cfg.rmsnorm_offset)
        a = [append_attention(b["attn"], hn, c, positions=pos,
                              cache_k=empty, cache_v=empty,
                              k_positions=no_pos, window=cfg.window)[0]
             for b, c in ((bp, cp), (br, cr))]
        held(*a, f"layer {i} attention")
        h = h + a[1]
        hn = rms_norm(br["ln2"], h, offset=cfg.rmsnorm_offset)
        f = [block_ffn(b, hn, c)[0] for b, c in ((bp, cp), (br, cr))]
        held(*f, f"layer {i} ffn")
        h = h + f[1]
    return {"arch": cfg.name, "policy": path, "act_dtype": cfg.act_dtype,
            "layers": cfg.n_layers, "rtol": rtol,
            "worst_err_over_max": worst}


# ---------------------------------------------------------------------------


def autotune_phase(torch, served, cfg, measurements: int = 2) -> dict:
    """``DecodeEngine.autotune_shapes`` at batch 4 for ``cfg``'s activation
    dtype, dense and grouped shapes; one line per shape with every eligible
    kernel's µs and the winner.  Every eligible hand kernel must have a time
    at every shape.  With two measurements the cache keeps the second, and
    the first shows whether the winners repeat."""
    from repro_torch.kernels.dispatch import eligible_kernels
    from repro_torch.serving.engine import DecodeEngine

    act = "int8" if cfg.act_dtype == "int8" else cfg.dtype
    engine = DecodeEngine(served, cfg, batch_size=4, max_len=256,
                          prefill_chunk=PREFILL_CHUNK, device=DEVICE)
    t0 = time.perf_counter()
    first = results = engine.autotune_shapes()
    seconds = time.perf_counter() - t0
    for _ in range(measurements - 1):
        results = engine.autotune_shapes()
    del engine
    table = {}
    for shape, us in sorted(results.items()):
        e = shape[0] if len(shape) == 4 else None
        m, k, n = shape[-3:]
        want = {s.name for s in eligible_kernels(m, k, n, act, e)}
        if set(us) != want or not all(t > 0 for t in us.values()):
            raise AssertionError(f"autotune {shape} {act}: timed "
                                 f"{sorted(us)}, eligible {sorted(want)}")
        winner = min(us, key=us.get)
        before = first[shape]
        emit("autotune", model=cfg.name, act=act, E=e, M=m, K=k, N=n, us=us,
             winner=winner, first_us=before,
             first_winner=min(before, key=before.get))
        key = ("" if e is None else f"E{e}:") + f"M{m}:K{k}:N{n}"
        table[key] = {"us": us, "winner": winner, "first_us": before}
    return {"model": cfg.name, "act": act, "seconds": seconds,
            "measurements": measurements, "shapes": table,
            "winners_repeated": sum(
                min(first[s], key=first[s].get) == min(r, key=r.get)
                for s, r in results.items())}


def packed_gb(tree) -> float:
    """GB of packed ternary bytes in a serving tree."""
    if isinstance(tree, dict):
        if "packed" in tree:
            return tree["packed"].numel() / 1e9
        return sum(packed_gb(v) for v in tree.values())
    return 0.0


def build_model(torch, model: str):
    """The model's serving tree at full width, built layer by layer from the
    seed; emits the init line."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.decode import init_serving_params

    cfg = get_config(model)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    served = init_serving_params(cfg, gen, DEVICE)
    torch.cuda.synchronize()
    emit("init", arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
         n_experts=cfg.n_experts, seconds=time.perf_counter() - t0,
         packed_gb=packed_gb(served),
         max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    torch.cuda.empty_cache()
    return cfg, served


def main() -> int:
    import gc

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card; nothing to run", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    # a fresh autotune cache of this run's own: the prior paths run on it
    # empty, the autotuned paths on what this run measured
    cache_path = os.path.join(OUT_DIR, "autotune.json")
    if os.path.exists(cache_path):
        os.unlink(cache_path)
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = cache_path
    from repro_torch.kernels import _build
    from repro_torch.kernels.dispatch import FLUSH_BYTES, get_autotune_cache

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = gpu_line()
    print(card, flush=True)
    clock, clock_max = sm_clocks_mhz()
    emit("env", gpu=card, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         sm_clock_mhz=clock, sm_clock_max_mhz=clock_max)

    t0 = time.perf_counter()
    logs = _build.build_all(CUDA_SOURCES)
    usage = {name: re.findall(r"(?:Used \d+ registers|\d+ bytes spill)"
                              r"[^\n]*", log)
             for name, log in logs.items() if log}
    # ptxas reports each kernel instantiation once, with its registers (a
    # source built before this run has no log and is not counted)
    emit("build", seconds=time.perf_counter() - t0,
         instantiations={name: sum(line.startswith("Used") for line in lines)
                         for name, lines in usage.items()},
         spilling={name: sum(bool(re.search(r"\b[1-9]\d* bytes spill", line))
                             for line in lines)
                   for name, lines in usage.items()},
         ptxas=usage)

    flush = torch.zeros(FLUSH_BYTES, dtype=torch.uint8, device=DEVICE)
    cases = kernel_cases(ARCH)
    rows = check_kernels(torch, cases, flush)
    checked = set(cases)
    for c in lut_ceilings(rows):
        emit("lut_ceiling", **c)
    for name, m, act in LAYER_ROWS:
        emit("layer", kernel=name, **layer_summary(rows, name, ARCH, m, act))

    cfg, served = build_model(torch, ARCH)
    paths = {}
    lengths = [3, 120, 17, 64, 33, 96, 5, 48]
    short = [3, 40, 20, 9]
    cfg8 = cfg.with_(act_dtype="int8")

    def run_path(name, c, model=ARCH, **kw):
        paths[name] = serve_path(torch, served, c, model, checked=checked,
                                 **kw)
        emit(f"serve_{name}", **paths[name])
        torch.cuda.empty_cache()

    # 1. bitnet on the prior, on the empty cache
    if get_autotune_cache().entries:
        raise AssertionError("the autotune cache is not empty")
    run_path("batch4", cfg, batch=4, lengths=lengths, new_tokens=16)
    run_path("batch1", cfg, batch=1, lengths=[40], new_tokens=16)
    run_path("int8", cfg8, batch=4, lengths=short, new_tokens=4)
    for c in (cfg, cfg8):
        emit("cross_check", **cross_check(torch, served, c))

    # 2. bitnet autotuned: measure, check whatever the measurements now
    # select, serve under auto
    tuned = {f"{ARCH}:{c.act_dtype}": autotune_phase(torch, served, c)
             for c in (cfg, cfg8)}
    more = sorted((selected_cases(ARCH, path_selection(ARCH, 4, "bfloat16"),
                                  "bfloat16")
                   | selected_cases(ARCH, path_selection(ARCH, 4, "int8"),
                                    "int8"))
                  - checked)
    rows += check_kernels(torch, more, flush)
    checked |= set(more)
    run_path("autotuned", cfg, batch=4, lengths=lengths, new_tokens=16)
    emit("cross_check", **cross_check(torch, served, cfg))
    run_path("autotuned_int8", cfg8, batch=4, lengths=short, new_tokens=4)
    emit("cross_check", **cross_check(torch, served, cfg8))

    # 3. bitnet pinned, one path per kernel ported after the first slice
    for name, (policy, act) in PINNED.items():
        c = (cfg8 if act == "int8" else cfg).with_(matmul_policy=policy)
        run_path(f"pinned_{name}", c, batch=4, lengths=short, new_tokens=4)
        emit("cross_check", **cross_check(torch, served, c))

    # 4. phi3.5-moe, with bitnet's tree freed first; its prior paths run
    # before its autotune (bitnet's measurements share none of its shapes)
    del served
    gc.collect()
    torch.cuda.empty_cache()
    cases = kernel_cases(MOE_ARCH)
    rows += check_kernels(torch, cases, flush)
    checked |= set(cases)
    for name, m, act in MOE_LAYER_ROWS:
        emit("layer", kernel=name, **layer_summary(
            rows, name, MOE_ARCH, capacity(MOE_ARCH, m), act))
    cfg, served = build_model(torch, MOE_ARCH)
    cfg8 = cfg.with_(act_dtype="int8")
    run_path("moe_batch4", cfg, MOE_ARCH, batch=4, lengths=lengths,
             new_tokens=16)
    per_step = paths["moe_batch4"]["launches_per_decode_step"]
    if per_step.get("grouped_dequant") != 3 * cfg.n_layers:
        raise AssertionError(f"grouped_dequant launched {per_step} times per "
                             f"decode step, not {3 * cfg.n_layers}")
    emit("cross_check", **cross_check(torch, served, cfg))
    emit("forced_check", **forced_check(torch, served, cfg))
    emit("layer_check", **layer_check(torch, served, cfg))
    w2a8 = cfg8.with_(matmul_policy="fixed:w2a8")
    run_path("moe_int8_w2a8", w2a8, MOE_ARCH, batch=4, lengths=short,
             new_tokens=4)
    emit("cross_check", **cross_check(torch, served, w2a8))
    emit("layer_check", **layer_check(torch, served, w2a8))

    tuned[f"{MOE_ARCH}:{cfg.act_dtype}"] = autotune_phase(
        torch, served, cfg, measurements=1)
    more = sorted(selected_cases(MOE_ARCH, path_selection(
        MOE_ARCH, 4, "bfloat16"), "bfloat16") - checked)
    rows += check_kernels(torch, more, flush)
    checked |= set(more)
    run_path("moe_autotuned", cfg, MOE_ARCH, batch=4, lengths=lengths,
             new_tokens=16)
    emit("cross_check", **cross_check(torch, served, cfg,
                                      routing_may_differ=True))
    emit("forced_check", **forced_check(torch, served, cfg))
    emit("layer_check", **layer_check(torch, served, cfg))
    RECORD["autotune"] = tuned
    del served, flush

    kernels = []
    for name, (src, replaces, model, m, act) in SOURCES.items():
        s = layer_summary(rows, name, model, m, act)
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": sum(p["launches"][name] for p in paths.values()),
            "launches_by_path": {k: p["launches"][name]
                                 for k, p in paths.items()
                                 if p["launches"][name]},
            **s})
    RECORD["kernels"] = kernels
    RECORD["seconds"] = time.perf_counter() - t_start
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as fh:
        json.dump(RECORD, fh, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
