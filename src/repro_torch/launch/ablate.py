"""Packing ablation on one card: the paper's bandwidth claim, measured.

Builds bitnet's bf16 tree (``model.init_params``) and its packed serving
tree (``decode.init_serving_params``, 1.6-bit base-3 projections) from one
seed, and for each prints

  * the weight GB (the whole tree, and its ternary projections alone);
  * one decode step's memory term, from ``launch.op_cost`` on fake tensors
    (the roofline bytes over the H100's 3.35 TB/s);
  * on the card, measured: the wall ms of a decode step (median of 10
    after 3 warm-up steps, each ended by a synchronize) and its busy ms
    (the summed device time of its kernels, from ``torch.profiler`` as
    ``launch/profile.py`` computes it);
  * the largest logit difference between the two trees, held to bitnet's
    2^-3, and each tree's distance from the plain path run in f64
    (``decode.f64_params`` under ``fixed:ref``): where the bf16 tree
    itself lies over 2^-3 from those, the drift is the bf16 model's own
    (no hand kernel runs in that arm), and the packed tree is held within
    that distance + 2^-3 of both (the rule ``chip_smoke.py``'s
    ``cross_check`` applies to ``fixed:ref``).

Both trees hold the same ternary model.  In the bf16 tree every ternary
projection is its trits times its absmean scale, in bf16, each matrix with
the scale its packed bytes carry (:func:`ternary_grid`), and it runs as a
plain bf16 model (``quant="fp"``: ``layers.linear`` multiplies the stored
weights, as a bf16 deployment would; its GEMMs sum in f32 throughout, as
the kernels do, with no bf16 reduced-precision reductions).  The packed
tree's projections go through dispatch on the prior (``lut_gather`` at
bitnet's shapes and M = the batch).  Both take bf16 activations.  (The QAT
branch's fake quant, ``w + (wq - w).detach()``, is not bitwise ``wq`` in
bf16: through it every weight moves by up to an ulp, and bitnet's logits
part from the packed tree's by more than 2^-3 at 128 x 4096.)  The KV
cache holds ``--seq - 1`` positions of seeded keys and values; every step
decodes the next position of every row.

The reference read this ablation from the compiled roofline
(``launch/ablate.py``: 256 TPU chips); here it is one card, measured.

Usage:
  python -m repro_torch.launch.ablate [--arch bitnet-b1.58-2b] [--seq 4096]
      [--batch 128] [--device cuda]
  python -m repro_torch.launch.ablate --smoke --device cpu --seq 64 --batch 4
"""

from __future__ import annotations

import argparse
import statistics
import time

import torch

from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.core.quantization import dequantize, ternarize
from repro_torch.device import resolve_device
from repro_torch.launch import dryrun, op_cost
from repro_torch.launch import roofline as rl
from repro_torch.models.decode import (FP_PARENTS, FP_TOP, TERNARY_KEYS,
                                       bind_serving_weights, decode_step,
                                       f64_params, init_cache,
                                       init_serving_params,
                                       quantize_for_serving)
from repro_torch.models.model import init_params

#: bitnet's logit bound between two paths of one model (the port's 2^-3)
LOGIT_ATOL = 2.0 ** -3


def weight_bytes(tree) -> tuple[int, int]:
    """``(every leaf's bytes, the ternary projections' bytes)``: packed
    bytes in a serving tree, bf16 weights in a training tree."""
    def proj(node, path=()):
        if isinstance(node, dict):
            leaf = node.get("packed")
            if leaf is None and "w" in node and path and \
                    path[-1] in TERNARY_KEYS and \
                    not set(path) & (FP_PARENTS | FP_TOP):
                leaf = node["w"]
            if leaf is not None:
                return leaf.numel() * leaf.element_size()
            return sum(proj(v, path + (k,)) for k, v in node.items())
        return 0

    return dryrun.tree_bytes(tree), proj(tree)


def ternary_grid(p, cfg):
    """The training tree ``p`` with each ternary projection replaced by its
    trits times its absmean scale in bf16, matrix by matrix as
    ``decode.quantize_for_serving`` packs them: the serving artifact's
    weights, stored in bf16."""
    def snap(w):
        mats = [dequantize(*ternarize(m), dtype=w.dtype)
                for m in w.reshape(-1, *w.shape[-2:])]
        return torch.stack(mats).reshape(w.shape)

    def walk(node, path):
        if isinstance(node, dict):
            if "w" in node and path and path[-1] in TERNARY_KEYS and \
                    not set(path) & (FP_PARENTS | FP_TOP):
                return dict(node, w=snap(node["w"]))
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return node

    return walk(p, ())


def memory_term(cfg, batch: int, seq: int, packed: bool,
                device: torch.device) -> rl.Roofline:
    """One decode step's roofline on fake tensors: the bf16 tree or the
    packed one, against a ``seq``-position cache of ``batch`` rows."""
    with dryrun.fake_mode():
        params = init_params(cfg, torch.Generator(device=device), device)
        params = (quantize_for_serving if packed else ternary_grid)(params,
                                                                    cfg)
        cache = init_cache(cfg, batch, seq, device=device)
        tokens = torch.empty(batch, dtype=torch.int32, device=device)
        index = torch.empty(batch, dtype=torch.int32, device=device)
        h = op_cost.analyze(lambda p, c, t, i: decode_step(p, cfg, c, t, i),
                            params, cache, tokens, index)
    return rl.Roofline(1, h["flops"], h["bytes"], h["collective_bytes"])


def filled_cache(cfg, batch: int, seq: int, device: torch.device,
                 seed: int) -> dict:
    """A ``seq``-slot cache holding positions ``0 .. seq-2`` of seeded
    keys and values in every row; the last slot is empty."""
    cache = init_cache(cfg, batch, seq, device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    for name in ("k", "v"):
        cache[name].normal_(generator=g)
    cache["pos"].copy_(torch.arange(seq, dtype=torch.int32, device=device))
    cache["pos"][..., seq - 1] = -1
    return cache


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(step, device: torch.device, steps: int, warmup: int) -> dict:
    """Wall ms of ``step()`` (median of ``steps`` after ``warmup``, each
    ended by a synchronize) and, on the card, its busy ms (three traced
    steps)."""
    for _ in range(warmup):
        step()
    _sync(device)
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        step()
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    out = {"wall_ms": statistics.median(times), "wall_ms_all": times,
           "busy_ms": None, "idle_share": None}
    if device.type == "cuda":
        from torch.profiler import ProfilerActivity, profile

        from repro_torch.launch.profile import _breakdown

        traced = 3
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(traced):
                step()
            _sync(device)
            wall = time.perf_counter() - t0
        b = _breakdown(prof, wall, traced)
        out.update(busy_ms=b["device_busy_ms_per_step"],
                   idle_share=b["device_idle_share"],
                   kernels_per_step=b["kernel_launches_per_step"])
    return out


def run(cfg, batch: int, seq: int, device: torch.device, seed: int = 0,
        steps: int = 10, warmup: int = 3) -> dict:
    """Both arms of the ablation (see the module docstring)."""
    packed_cfg = cfg.with_(matmul_policy="prior")
    bf16_cfg = cfg.with_(quant="fp")
    arms = {}
    for name, arm_cfg in (("bf16", bf16_cfg), ("packed", packed_cfg)):
        t0 = time.perf_counter()
        roof = memory_term(arm_cfg, batch, seq, name == "packed", device)
        arms[name] = {"memory_term_ms": roof.memory_s * 1e3,
                      "compute_term_ms": roof.compute_s * 1e3,
                      "roofline_bytes": roof.bytes_per_device,
                      "roofline_flops": roof.flops_per_device,
                      "trace_s": time.perf_counter() - t0}
    gen = torch.Generator(device=device).manual_seed(seed)
    bf16 = ternary_grid(init_params(bf16_cfg, gen, device), bf16_cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    packed = init_serving_params(packed_cfg, gen, device)
    for name, tree in (("bf16", bf16), ("packed", packed)):
        total, proj = weight_bytes(tree)
        arms[name].update(weight_gb=total / 1e9, ternary_weight_gb=proj / 1e9)
    bound = bind_serving_weights(packed, packed_cfg)
    cache = filled_cache(cfg, batch, seq, device, seed + 1)
    g = torch.Generator(device=device).manual_seed(seed + 2)
    tokens = torch.randint(2, cfg.vocab_size, (batch,), generator=g,
                           device=device, dtype=torch.int32)
    index = torch.full((batch,), seq - 1, dtype=torch.int32, device=device)
    f64_cfg = packed_cfg.with_(matmul_policy="fixed:ref")
    logits = {}
    matmul = torch.backends.cuda.matmul
    reduced = matmul.allow_bf16_reduced_precision_reduction
    # the bf16 arm's GEMMs sum in f32 throughout, as the kernels do
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        for name, tree, arm_cfg in (("bf16", bf16, bf16_cfg),
                                    ("packed", bound, packed_cfg),
                                    ("f64", f64_params(packed), f64_cfg)):
            def step(tree=tree, arm_cfg=arm_cfg):
                return decode_step(tree, arm_cfg, cache, tokens, index)[0]

            with torch.no_grad():
                cache["pos"][..., seq - 1] = -1
                logits[name] = step()[:, :cfg.vocab_size].double()
                if name != "f64":
                    arms[name].update(measure(step, device, steps, warmup))
    finally:
        matmul.allow_bf16_reduced_precision_reduction = reduced

    def dist(a, b):
        return float((logits[a] - logits[b]).abs().max())

    diff, d_bf16, d_packed = (dist("packed", "bf16"), dist("bf16", "f64"),
                              dist("packed", "f64"))
    held = diff <= LOGIT_ATOL
    # the bf16 model's own drift (the repo's rule where ``fixed:ref``
    # itself lies over the bound from the f64 logits): the bf16 arm, which
    # runs no hand kernel, in ``fixed:ref``'s place
    drift = d_bf16 > LOGIT_ATOL and max(diff, d_packed) <= d_bf16 + LOGIT_ATOL
    return {"arch": cfg.name, "n_layers": cfg.n_layers, "seq": seq,
            "batch": batch, "device": str(device),
            "card": (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else None),
            "kv_cache_gb": dryrun.tree_bytes(cache) / 1e9,
            "bf16": arms["bf16"], "packed": arms["packed"],
            "logits_max_abs_diff": diff, "logits_atol": LOGIT_ATOL,
            "max_abs_logit": float(logits["f64"].abs().max()),
            "f64_distance_bf16": d_bf16, "f64_distance_packed": d_packed,
            "held_to_atol": held, "drift_held": drift,
            "logits_held": held or drift}


def report(r: dict) -> str:
    b, p = r["bf16"], r["packed"]

    def ms(x):
        return "not measured" if x is None else f"{x:.2f} ms"

    return "\n".join([
        f"{r['arch']} × decode seq={r['seq']} batch={r['batch']} (one card: "
        f"{r['card'] or r['device']}; KV cache {r['kv_cache_gb']:.1f} GB)",
        f"  weights: bf16 {b['weight_gb']:.2f} GB vs packed "
        f"{p['weight_gb']:.2f} GB ({b['weight_gb'] / p['weight_gb']:.1f}x); "
        f"ternary projections {b['ternary_weight_gb']:.2f} vs "
        f"{p['ternary_weight_gb']:.2f} GB "
        f"({b['ternary_weight_gb'] / p['ternary_weight_gb']:.1f}x)",
        f"  memory term: bf16 {b['memory_term_ms']:.2f} ms vs packed "
        f"{p['memory_term_ms']:.2f} ms "
        f"({b['memory_term_ms'] / p['memory_term_ms']:.2f}x)",
        f"  measured step: bf16 {ms(b['wall_ms'])} wall, {ms(b['busy_ms'])} "
        f"busy vs packed {ms(p['wall_ms'])} wall, {ms(p['busy_ms'])} busy",
        f"  logits: max |packed - bf16| = {r['logits_max_abs_diff']:.4g} "
        f"(bound {r['logits_atol']}); from the f64 plain path: bf16 "
        f"{r['f64_distance_bf16']:.4g}, packed "
        f"{r['f64_distance_packed']:.4g} (logits to "
        f"{r['max_abs_logit']:.3g})"])


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="bitnet-b1.58-2b")
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--device", default=None)
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced config (for the CPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    r = run(cfg, args.batch, args.seq, device)
    print(report(r), flush=True)
    if not r["logits_held"]:
        raise SystemExit(f"logits differ by {r['logits_max_abs_diff']} > "
                         f"{r['logits_atol']}, and not by the bf16 model's "
                         f"own drift")
    return r


if __name__ == "__main__":
    main()
