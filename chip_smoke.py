#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the six hand-written CUDA kernels from
``src/repro_torch/kernels/csrc`` (``lut_gather``, ``lut_onehot``, ``tl2``,
``dequant_packed``, ``w2a8``, ``signflip``), holds each against its plain
PyTorch version at bitnet-b1.58-2b's projection shapes and times it, then
serves the full-width model (30 layers, d_model 2560, random weights from a
seed) through ``DecodeEngine`` under ``ContinuousScheduler`` on these paths:

  * on the analytical prior, with an empty autotune cache: batch 4 (the
    main path, ``lut_gather``), batch 1 and int8 activations (``tl2``);
  * autotuned: ``DecodeEngine.autotune_shapes`` times every eligible kernel
    at the engine's shapes (bf16 and int8, batch 4; twice, to show how far
    the winners repeat), then batch 4 serves under ``auto`` on those
    measurements, once with bf16 and once with int8 activations;
  * pinned, one per newly ported kernel: ``fixed:lut_onehot``,
    ``fixed:dequant_packed``, ``fixed:signflip`` (bf16) and ``fixed:w2a8``
    (int8), batch 4.

The kernel phase checks every (kernel, M, activation dtype) that dispatch
selects on any of those paths, decode and prefill alike (the autotuned
path's selections are checked once they are known), and each path asserts
that what it selected was checked.  Every serving path is driven with the
kernels' launch counters set to 0 just before it and read just after; each
kernel the path selects must have launched, and no other.  After each path
the prefill logits of one prompt through its kernels are held against the
plain ``ref`` path on the card.

Each phase prints one JSON line; a fuller record goes to
``smoke_out/chip_smoke.json``.  The last two lines are the kernel summary
and ``{"ok": true, "device": {...}}``.  Any failure ends the process with a
nonzero exit and no result line; so does a machine without a CUDA card.

Tolerances:
  * kernel vs plain, float inputs: both accumulate in f32 in different
    orders, so they agree to a few f32 ulps of the row's absolute sum:
    atol = 1e-5 * max_b sum_k |x[b, k]|.  int8 inputs: every partial sum is an
    integer below 2^24, so the results must be equal.
    ``w2a8`` sums in int32 and must equal the plain version and the int64
    product.
  * prefill logits, kernels vs ``ref``: the two differ only in the f32
    summation order inside each projection; where that flips a bf16 rounding
    of an activation the change is one bf16 ulp, and through 30 residual
    layers the logits (magnitude < 8) move by a few bf16 ulps at most:
    atol = 2^-3, four ulps at magnitude 4 to 8.  With int8 activations
    every kernel sums the same integers exactly (int32, or f32 below 2^24)
    and the same scales follow, so every int8 path (prior, autotuned,
    ``fixed:w2a8``) must equal ``fixed:ref`` exactly (atol 0).
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "smoke_out")
SEED = 0
ARCH = "bitnet-b1.58-2b"
#: (K, N) of bitnet's ternary projections and how many of each one layer has:
#: wq, wo (attention) | wk, wv | wg, wi | down (the FFN's wo)
LAYER_KN = {(2560, 2560): 2, (2560, 640): 2, (2560, 6912): 2, (6912, 2560): 1}
#: H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
INT8_OPS_PER_S = 1979e12
LOGIT_ATOL = 2.0 ** -3
DEVICE = "cuda"
#: admission prefill chunk of every serving path (the M of prefill matmuls)
PREFILL_CHUNK = 32
#: serving paths on the prior: name -> (decode batch, activation dtype)
PATHS = {"batch4": (4, "bfloat16"), "batch1": (1, "bfloat16"),
         "int8": (4, "int8")}
#: pinned paths (batch 4): name -> (policy, activation dtype)
PINNED = {"lut_onehot": ("fixed:lut_onehot", "bfloat16"),
          "dequant_packed": ("fixed:dequant_packed", "bfloat16"),
          "signflip": ("fixed:signflip", "bfloat16"),
          "w2a8": ("fixed:w2a8", "int8")}
#: every hand kernel: name -> (CUDA source, the TPU kernel it replaces, the
#: (M, act) its summary in the kernels line is taken at)
SOURCES = {
    "lut_gather": ("src/repro_torch/kernels/csrc/lut_matmul.cu",
                   "src/repro/kernels/lut_matmul.py:96", 4, "bfloat16"),
    "lut_onehot": ("src/repro_torch/kernels/csrc/lut_matmul.cu",
                   "src/repro/kernels/lut_matmul.py:96", 4, "bfloat16"),
    "tl2": ("src/repro_torch/kernels/csrc/tl2_matmul.cu",
            "src/repro/kernels/tl2_matmul.py:176", 1, "bfloat16"),
    "dequant_packed": ("src/repro_torch/kernels/csrc/dequant_matmul.cu",
                       "src/repro/kernels/dequant_matmul.py:59", 4,
                       "bfloat16"),
    "w2a8": ("src/repro_torch/kernels/csrc/w2a8_matmul.cu",
             "src/repro/kernels/w2a8_matmul.py:50", 4, "int8"),
    "signflip": ("src/repro_torch/kernels/csrc/signflip_matmul.cu",
                 "src/repro/kernels/signflip_matmul.py:48", 4, "bfloat16"),
}
HAND_KERNELS = tuple(SOURCES)

RECORD: dict = {}


def emit(phase: str, **fields) -> None:
    RECORD.setdefault("phases", []).append({"phase": phase, **fields})
    print(json.dumps({"phase": phase, **fields}), flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# per-kernel check and timing
# ---------------------------------------------------------------------------


def time_cold(torch, fn, reps: int, flush) -> float:
    """Mean device time (ms) of ``fn()`` with the L2 cache flushed before
    every launch, as a decode step finds each layer's weights."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def kernel_case(torch, name: str, m: int, k: int, n: int, act: str, flush):
    from repro_torch.core import encoding
    from repro_torch.kernels import dequant_matmul as deq
    from repro_torch.kernels import lut_matmul as lut
    from repro_torch.kernels import signflip_matmul as sf
    from repro_torch.kernels import tl2_matmul as tl2
    from repro_torch.kernels import w2a8_matmul as w8
    from repro_torch.kernels.dispatch import TernaryWeight

    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(SEED + 7 * m + k + n)
    if act == "int8":
        x = torch.randint(-127, 128, (m, k), generator=g, device=dev,
                          dtype=torch.int8)
    else:
        x = torch.randn((m, k), generator=g, device=dev, dtype=torch.bfloat16)
    trits = torch.randint(-1, 2, (n, k), generator=g, device=dev,
                          dtype=torch.int8)
    # base-3 bytes with the serving artifact's 128-byte row padding
    packed = encoding.pack_base3(trits)
    packed = torch.nn.functional.pad(packed, (0, (-packed.shape[1]) % 128))
    w = TernaryWeight.from_packed(packed, 1.0, k)
    mu = w.mu
    rate = F32_OPS_PER_S
    packed_bytes = n * -(-k // encoding.TRITS_PER_BYTE)
    # ``ops`` is the function's floor on this weight encoding, not what the
    # kernel's design spends: one add per trit, key or pair and row, plus
    # the table build where the encoding needs one
    if name in ("lut_gather", "lut_onehot"):
        keys = w.keys()
        G = keys.shape[1]
        xk = torch.nn.functional.pad(x, (0, G * mu - k))
        fn, plain_fn = ((lut.lut_matmul, lut.lut_matmul_torch)
                        if name == "lut_gather" else
                        (lut.lut_onehot_matmul, lut.lut_onehot_matmul_torch))
        kernel = lambda: fn(xk, keys, mu)                       # noqa: E731
        plain = lambda: plain_fn(xk, keys, mu)                  # noqa: E731
        wbytes = keys.numel() * keys.element_size()
        # whichever fetch computes it: the table build, then one add per
        # key and row
        ops = m * G * encoding.table_size(mu) + m * n * G
    elif name == "tl2":
        words = w.tl2()
        kernel = lambda: tl2.tl2_matmul(x, words, k)            # noqa: E731
        plain = lambda: tl2.tl2_matmul_torch(x, words, k)       # noqa: E731
        wbytes = words.numel() * words.element_size()
        Q = words.shape[1] * tl2.PAIRS_PER_WORD
        ops = m * n * Q + m * Q * 9          # fetch-accumulate + table build
    elif name == "dequant_packed":
        kernel = lambda: deq.packed_matmul(x, packed, k)        # noqa: E731
        plain = lambda: deq.packed_matmul_torch(x, packed, k)   # noqa: E731
        wbytes = packed_bytes                # the padding is never read
        ops = m * n * k
    elif name == "w2a8":
        kernel = lambda: w8.w2a8_matmul(x, packed, k)           # noqa: E731
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
    else:
        raise KeyError(name)
    wd = trits.to(torch.bfloat16)
    xb = x.to(torch.bfloat16)
    library = lambda: torch.matmul(xb, wd.T)                    # noqa: E731

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err = float((got.double() - want.double()).abs().max())
    if act == "int8":
        exact = torch.equal(got, want) and torch.equal(
            got.cpu().to(torch.int64),
            x.cpu().to(torch.int64) @ trits.cpu().to(torch.int64).T)
        tol = 0.0
        if not exact:
            raise AssertionError(f"{name} int8 M={m} K={k} N={n}: not exact "
                                 f"(max abs err {err})")
    else:
        tol = 1e-5 * float(x.double().abs().sum(-1).max()) + 1e-6
        if not err <= tol:
            raise AssertionError(f"{name} M={m} K={k} N={n}: max abs err "
                                 f"{err} > {tol}")
    nbytes = x.numel() * x.element_size() + wbytes + m * n * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    row = {"kernel": name, "M": m, "K": k, "N": n, "act": act,
           "max_abs_err": err, "tol": tol,
           "ms": time_cold(torch, kernel, 20, flush),
           "plain_ms": time_cold(torch, plain, 5, flush),
           "library_ms": time_cold(torch, library, 20, flush),
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": nbytes, "ops": ops, "ops_per_s": rate}
    return row


def path_selection(batch: int, act: str, policy: str | None = None) -> dict:
    """What dispatch selects on one serving path: ``{(M, K, N): kernel}``
    for its decode M (the batch) and its prefill M (the chunk)."""
    from repro_torch.kernels.dispatch import select_kernel

    return {(m, k, n): select_kernel(m, k, n, act, policy=policy).name
            for m in (batch, PREFILL_CHUNK) for k, n in LAYER_KN}


def selected_cases(selection: dict, act: str) -> set:
    """The ``(kernel, M, act)`` of the hand kernels in a path selection."""
    return {(name, m, act) for (m, _, _), name in selection.items()
            if name in HAND_KERNELS}


def kernel_cases() -> list[tuple]:
    """``(kernel, M, act)`` to check before serving: bitnet's decode points
    at batch 4, 1, 2 and int8 batch 4, each newly ported kernel at decode
    (M=4) and prefill (M=32), plus every one that a prior or pinned serving
    path selects."""
    cases = {("lut_gather", 4, "bfloat16"), ("lut_gather", 32, "bfloat16"),
             ("tl2", 1, "bfloat16"), ("tl2", 2, "bfloat16"),
             ("tl2", 4, "int8")}
    for batch, act in PATHS.values():
        cases |= selected_cases(path_selection(batch, act), act)
    for policy, act in PINNED.values():
        cases |= selected_cases(path_selection(4, act, policy), act)
    return sorted(cases)


def check_kernels(torch, cases, flush) -> list[dict]:
    rows = []
    for name, m, act in cases:
        for k, n in LAYER_KN:
            row = kernel_case(torch, name, m, k, n, act, flush)
            emit("kernel", **row)
            rows.append(row)
    return rows


def layer_summary(rows: list[dict], name: str, m: int, act: str) -> dict:
    """One kernel's numbers for the seven projections of one layer at the
    main path's M (sums of the per-shape times)."""
    sel = {(r["K"], r["N"]): r for r in rows
           if r["kernel"] == name and r["M"] == m and r["act"] == act}
    tot = {key: sum(sel[kn][key] * c for kn, c in LAYER_KN.items())
           for key in ("ms", "plain_ms", "library_ms")}
    t_bytes = sum(sel[kn]["bytes"] * c for kn, c in LAYER_KN.items()) \
        / HBM_BYTES_PER_S * 1e3
    t_ops = sum(sel[kn]["ops"] / sel[kn]["ops_per_s"] * c
                for kn, c in LAYER_KN.items()) * 1e3
    return {**tot, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "max_abs_err": max(r["max_abs_err"] for r in rows
                               if r["kernel"] == name),
            "at": f"M={m} {act}, sum over one layer's 7 projections"}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def make_requests(lengths, new_tokens: int, vocab: int, seed: int):
    import numpy as np

    from repro_torch.serving.engine import Request

    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(2, vocab, size=n).tolist(),
                    max_new_tokens=new_tokens) for n in lengths]


def serve_path(torch, served, cfg, *, batch: int, lengths, new_tokens: int,
               checked: set) -> dict:
    """Serve one path (``cfg.matmul_policy``) and return its record.  A
    one-request warm-up first derives the kernels' weight encodings (set-up,
    untimed); then the counters are set to 0, the requests are served, and
    the counters read.  Every hand kernel the path selects must be in
    ``checked`` and must have launched; no other hand kernel may have."""
    from repro_torch.kernels.dispatch import (launch_counts,
                                              reset_launch_counts)
    from repro_torch.serving.engine import DecodeEngine

    act = "int8" if cfg.act_dtype == "int8" else cfg.dtype
    selection = path_selection(batch, act, cfg.matmul_policy)
    expect = {name for name, _, _ in selected_cases(selection, act)}
    unchecked = sorted(selected_cases(selection, act) - checked)
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
    reset_launch_counts()
    t0 = time.perf_counter()
    engine.serve(reqs)
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
    selected = {f"M{m}:K{k}:N{n}": name
                for (m, k, n), name in selection.items()}
    n_tok = sum(len(r.out) for r in reqs)
    step_ms = decode_step_ms(torch, engine, cfg)
    del engine
    return {"policy": cfg.matmul_policy or "auto", "act": act,
            "batch": batch, "requests": len(reqs), "prompt_lengths": lengths,
            "new_tokens": n_tok, "seconds": dt, "tokens_per_s": n_tok / dt,
            "decode_step_ms": step_ms, "launches": counts,
            "selected": selected}


def decode_step_ms(torch, engine, cfg, steps: int = 10) -> float:
    """Wall time of one decode step with every slot live (after the path's
    counters were read): admit one request per slot, warm up, time
    ``steps`` scheduler steps ending in a synchronize."""
    state = engine.sched_start()
    for slot, r in enumerate(make_requests([8] * engine.B, steps + 4,
                                           cfg.vocab_size, SEED + 3)):
        state = engine.sched_admit(state, slot, r)
    for _ in range(2):
        state, _, _ = engine.sched_step(state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, _, _ = engine.sched_step(state)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3


def cross_check(torch, served, cfg) -> dict:
    """Prefill logits of one prompt through the path's kernels
    (``cfg.matmul_policy``) and through ``fixed:ref``, chunk by chunk as
    admission runs it, at ``cfg``'s activation dtype: within ``LOGIT_ATOL``
    with float activations, equal with int8 ones."""
    import numpy as np

    from repro_torch.models.decode import (bind_serving_weights, init_cache,
                                           prefill_chunk, prefill_chunks_of)

    prompt = np.random.default_rng(SEED + 5).integers(2, cfg.vocab_size,
                                                      size=45)
    path = cfg.matmul_policy or "auto"
    atol = 0.0 if cfg.act_dtype == "int8" else LOGIT_ATOL
    logits = {}
    for policy in (path, "fixed:ref"):
        c = cfg.with_(matmul_policy=policy)
        p = bind_serving_weights(served, c)
        cache = init_cache(c, 1, 256, device=DEVICE)
        for start, valid in prefill_chunks_of(len(prompt), PREFILL_CHUNK):
            toks = torch.ones((1, PREFILL_CHUNK), dtype=torch.int64,
                              device=DEVICE)
            toks[0, :valid] = torch.from_numpy(prompt[start:start + valid])
            pos = torch.full((1, PREFILL_CHUNK), -1, dtype=torch.int32,
                             device=DEVICE)
            pos[0, :valid] = torch.arange(start, start + valid,
                                          dtype=torch.int32)
            cache, out = prefill_chunk(p, c, cache, toks, pos, valid - 1)
        logits[policy] = out[0, :cfg.vocab_size].float()
        del p, cache
    kern, ref = logits[path], logits["fixed:ref"]
    if not (torch.isfinite(kern).all() and torch.isfinite(ref).all()):
        raise AssertionError("non-finite prefill logits")
    diff = float((kern - ref).abs().max())
    if not diff <= atol:
        raise AssertionError(f"prefill logits: {path} vs ref max abs diff "
                             f"{diff} > {atol}")
    return {"policy": path,
            "act_dtype": cfg.act_dtype, "max_abs_diff": diff, "atol": atol,
            "max_abs_logit": float(ref.abs().max()),
            "argmax_equal": bool(kern.argmax() == ref.argmax())}


# ---------------------------------------------------------------------------


def autotune_phase(torch, served, cfg) -> dict:
    """``DecodeEngine.autotune_shapes`` at batch 4 for ``cfg``'s activation
    dtype; one line per shape with every eligible kernel's µs and the
    winner.  Every eligible hand kernel must have a time at every shape."""
    from repro_torch.kernels.dispatch import eligible_kernels
    from repro_torch.serving.engine import DecodeEngine

    act = "int8" if cfg.act_dtype == "int8" else cfg.dtype
    engine = DecodeEngine(served, cfg, batch_size=4, max_len=256,
                          prefill_chunk=PREFILL_CHUNK, device=DEVICE)
    t0 = time.perf_counter()
    first = engine.autotune_shapes()
    seconds = time.perf_counter() - t0
    # the cache keeps the second measurement; the first shows whether the
    # winners repeat from one measurement to the next
    results = engine.autotune_shapes()
    del engine
    table = {}
    for (m, k, n), us in sorted(results.items()):
        want = {s.name for s in eligible_kernels(m, k, n, act)}
        if set(us) != want or not all(t > 0 for t in us.values()):
            raise AssertionError(f"autotune M{m} K{k} N{n} {act}: timed "
                                 f"{sorted(us)}, eligible {sorted(want)}")
        winner = min(us, key=us.get)
        before = first[(m, k, n)]
        emit("autotune", act=act, M=m, K=k, N=n, us=us, winner=winner,
             first_us=before, first_winner=min(before, key=before.get))
        table[f"M{m}:K{k}:N{n}"] = {"us": us, "winner": winner,
                                    "first_us": before}
    return {"act": act, "seconds": seconds, "shapes": table,
            "winners_repeated": sum(
                min(first[s], key=first[s].get) == min(r, key=r.get)
                for s, r in results.items())}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card; nothing to run", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    # a fresh autotune cache of this run's own: the prior paths run on it
    # empty, the autotuned path on what this run measured
    cache_path = os.path.join(OUT_DIR, "autotune.json")
    if os.path.exists(cache_path):
        os.unlink(cache_path)
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = cache_path
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.dispatch import get_autotune_cache
    from repro_torch.models.decode import quantize_for_serving
    from repro_torch.models.model import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = gpu_line()
    print(card, flush=True)
    emit("env", gpu=card, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])

    t0 = time.perf_counter()
    logs = _build.build_all(["lut_matmul", "tl2_matmul", "dequant_matmul",
                             "w2a8_matmul", "signflip_matmul"])
    usage = {name: re.findall(r"Used \d+ registers[^\n]*", log)
             for name, log in logs.items()}
    emit("build", seconds=time.perf_counter() - t0, ptxas=usage)

    cases = kernel_cases()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)
    rows = check_kernels(torch, cases, flush)
    checked = set(cases)

    cfg = get_config(ARCH)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    t0 = time.perf_counter()
    served = quantize_for_serving(init_params(cfg, gen, DEVICE), cfg)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    emit("init", arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
         seconds=time.perf_counter() - t0,
         packed_gb=sum(leaf["packed"].numel() for blk in (
             served["blocks"]["attn"], served["blocks"]["ffn"])
             for leaf in blk.values() if "packed" in leaf) / 1e9)

    paths = {}
    lengths = [3, 120, 17, 64, 33, 96, 5, 48]
    short = [3, 40, 20, 9]
    cfg8 = cfg.with_(act_dtype="int8")

    def run_path(name, c, **kw):
        paths[name] = serve_path(torch, served, c, checked=checked, **kw)
        emit(f"serve_{name}", **paths[name])
        torch.cuda.empty_cache()

    # 1. the prior, on the empty cache
    if get_autotune_cache().entries:
        raise AssertionError("the autotune cache is not empty")
    run_path("batch4", cfg, batch=4, lengths=lengths, new_tokens=16)
    run_path("batch1", cfg, batch=1, lengths=[40], new_tokens=16)
    run_path("int8", cfg8, batch=4, lengths=short, new_tokens=4)
    for c in (cfg, cfg8):
        emit("cross_check", **cross_check(torch, served, c))

    # 2. autotuned: measure, check whatever the measurements now select,
    # serve under auto
    tuned = {c.act_dtype: autotune_phase(torch, served, c)
             for c in (cfg, cfg8)}
    RECORD["autotune"] = tuned
    more = sorted((selected_cases(path_selection(4, "bfloat16"), "bfloat16")
                   | selected_cases(path_selection(4, "int8"), "int8"))
                  - checked)
    rows += check_kernels(torch, more, flush)
    checked |= set(more)
    run_path("autotuned", cfg, batch=4, lengths=lengths, new_tokens=16)
    emit("cross_check", **cross_check(torch, served, cfg))
    run_path("autotuned_int8", cfg8, batch=4, lengths=short, new_tokens=4)
    emit("cross_check", **cross_check(torch, served, cfg8))

    # 3. one pinned path per newly ported kernel
    for name, (policy, act) in PINNED.items():
        c = (cfg8 if act == "int8" else cfg).with_(matmul_policy=policy)
        run_path(f"pinned_{name}", c, batch=4, lengths=short, new_tokens=4)
        emit("cross_check", **cross_check(torch, served, c))
    del flush

    kernels = []
    for name, (src, replaces, m, act) in SOURCES.items():
        s = layer_summary(rows, name, m, act)
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": sum(p["launches"][name] for p in paths.values()),
            "launches_by_path": {k: p["launches"][name]
                                 for k, p in paths.items()},
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
