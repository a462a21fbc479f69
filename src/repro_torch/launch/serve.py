"""Serving launcher: build a model's packed 1.6-bit serving weights from a
seed, layer by layer, and serve generation through the continuous-batching
scheduler on the card.

Usage:
  python -m repro_torch.launch.serve --arch bitnet-b1.58-2b [--smoke] \
      [--batch 4] [--max-len 256] [--requests N] [--new-tokens 32] \
      [--prefill-chunk 32] [--admission-budget 0] [--act-dtype none|int8] \
      [--policy auto] [--autotune] [--prefix-cache] [--prefix-cache-mb 64] \
      [--scenario chat|rag|agentic|code] [--scenario-seed 0] \
      [--draft <arch>] [--spec-k 4] [--dynamic-spec-k] \
      [--discipline continuous|generational] [--device cuda|cpu] [--seed 0] \
      [--mesh DxM] [--dist-backend nccl|gloo]

``--arch`` takes bitnet-b1.58-2b, the dense qwen3-0.6b, gemma-7b,
qwen2.5-14b and yi-34b, phi3.5-moe-42b-a6.6b (16 experts, top-2, an MoE
FFN on every layer), zamba2-2.7b (54 Mamba2 layers and one shared
attention+FFN block after every 6th), xlstm-125m (alternating mLSTM/sLSTM
layers), whisper-large-v3 (encoder-decoder; the audio frontend is a stub
of zero frame embeddings) or internvl2-2b (the vision frontend is a stub of
zero embeddings over the first 64 positions); the last four admit each
request through one whole-prompt prefill.  Weights are random (there is no
checkpoint in the repository); ``decode.init_serving_params`` packs each
layer as it is drawn, so the bf16 tree is never held (phi3.5-moe's would
not fit the card).  Every ternary projection goes through
``kernels.dispatch.ternary_matmul``, every expert stack through
``grouped_ternary_matmul``; on the card the prior routes them to the
hand-written CUDA kernels (``lut_gather`` at M >= 3, ``tl2`` at M <= 2 and
for int8 activations, ``grouped_dequant`` for the experts).
``--autotune`` first times every eligible kernel at the engine's shapes
(``DecodeEngine.autotune_shapes``, recorded in the cache at
``$REPRO_TORCH_AUTOTUNE_CACHE``) so ``auto`` dispatches on the
measurements; ``--policy fixed:<kernel>`` pins one kernel (a dense pin maps
to its grouped counterpart on the experts).  The launcher prints how many
times each hand kernel launched.

``--scenario NAME`` replaces the fixed request list with a named
multi-tenant workload (``repro_torch.serving.workload``) replayed open-loop
under the wall clock: requests arrive on each tenant's seeded arrival
process, queue for real, and the launcher prints per-tenant p50/p95/p99
TTFT, TPOT p50 and SLO attainment.  The scenario sets the geometry
(``--max-len`` is raised to fit its longest prompt and generation);
``--smoke`` shrinks the scenario too.  ``--prefix-cache`` turns on hashed
shared-prefix KV reuse (block = one ``--prefill-chunk``, LRU under
``--prefix-cache-mb``), and the scheduler then admits cache-hot requests
first; the launcher prints the store's hit and residency line.
``--admission-budget`` caps prefill chunks per scheduler step (0 =
unbounded).

``--draft ARCH`` serves speculatively: a draft of that arch (its weights
drawn from ``--seed`` + 1; ``--smoke`` shrinks it too) proposes
``--spec-k`` - 1 tokens a round and the target verifies all ``--spec-k``
in one forward; greedy streams are unchanged.  It needs the target's
vocabulary (a mismatch raises ``ValueError``), and works with
``--scenario`` too.  ``--dynamic-spec-k`` sizes each request's draft
window from its measured acceptance.  The launcher prints the speculative
line: rounds, accepted drafted tokens and tokens per decode step.

``--discipline generational`` serves the fixed request list through
``DecodeEngine.run``: one batched prefill of the left-padded prompts, the
batch turning over at the pace of its slowest request (``--requests``
must not exceed ``--batch``; a ``--scenario`` replay is continuous).
The fixed requests' prompts are 2 tokens long, or the config's
``decode.min_prompt_len`` where that is longer (zamba2's ``ssm_conv - 1``,
a VLM's ``vision_tokens``).

``--mesh DxM`` (or ``PxDxM``) serves sharded (``DecodeEngine(mesh=...)``):
the launcher builds the CUDA kernels, then spawns D·M rank processes
(``launch.mesh.run_ranks``, rank ``r`` on ``cuda:<r % device_count>``)
over ``--dist-backend`` (``nccl`` by default; ``gloo`` to put several
ranks on one card, or on the CPU with ``--device cpu``).  Each rank builds
the weights from the seed and the engine keeps its slice; rank 0 prints.
The dense attention archs only, and not with ``--scenario`` (each rank's
wall clock would admit at its own times), ``--draft`` or
``--prefix-cache``.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time

import torch

from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.kernels.dispatch import launch_counts, reset_launch_counts
from repro_torch.models.decode import (init_serving_params, min_prompt_len,
                                       packed_bits_per_weight)
from repro_torch.serving.engine import DecodeEngine, Request
from repro_torch.serving.loadgen import (LoadGenerator, LoadResult,
                                         generate_trace, latency_summary)
from repro_torch.serving.scheduler import ContinuousScheduler
from repro_torch.serving.workload import get_scenario


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="serve the reduced (smoke-scale) config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--requests", type=int, default=None,
                    help="number of requests (default: --batch; may exceed "
                    "it, the scheduler queues and refills slots)")
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--prefill-chunk", type=int, default=32,
                    help="admission prefill chunk size")
    ap.add_argument("--admission-budget", type=int, default=0,
                    help="max prefill chunks per scheduler step (0 = "
                    "unbounded)")
    ap.add_argument("--act-dtype", choices=["none", "int8"], default="none",
                    help="int8 quantizes activations per token in front of "
                    "every packed matmul (the W1.58A8 path)")
    ap.add_argument("--policy", default=None,
                    help="ternary-matmul policy: auto | prior | "
                    "fixed:<kernel> (default: auto)")
    ap.add_argument("--autotune", action="store_true",
                    help="time every eligible kernel at the engine's shapes "
                    "before serving, so 'auto' dispatches on measurements")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="hashed shared-prefix KV reuse: admission splices "
                    "cached KV blocks (block = one --prefill-chunk) instead "
                    "of recomputing them, and the scheduler admits "
                    "cache-hot requests first")
    ap.add_argument("--prefix-cache-mb", type=float, default=64.0,
                    help="prefix-cache byte budget in MiB (LRU eviction)")
    ap.add_argument("--scenario", default=None,
                    help="replay a named multi-tenant workload (chat | rag "
                    "| agentic | code) open-loop under the wall clock "
                    "instead of the fixed request list (--smoke shrinks it)")
    ap.add_argument("--scenario-seed", type=int, default=0,
                    help="arrival-trace seed for --scenario")
    ap.add_argument("--draft", default=None,
                    help="draft arch for speculative decoding (greedy only; "
                    "must share the target's vocabulary)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="candidates per speculative verify (1 free target "
                    "token + spec-k - 1 drafted)")
    ap.add_argument("--dynamic-spec-k", action="store_true",
                    help="with --draft: size each request's next draft "
                    "window from its measured acceptance, in [2, --spec-k]")
    ap.add_argument("--discipline", choices=["continuous", "generational"],
                    default="continuous",
                    help="generational: DecodeEngine.run, one batched "
                    "prefill and a batch that turns over at the pace of its "
                    "slowest request (--requests <= --batch)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (plain PyTorch kernels)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    ap.add_argument("--mesh", default=None,
                    help="serve sharded on DxM (data x model) or PxDxM "
                    "ranks, one process each")
    ap.add_argument("--dist-backend", choices=["nccl", "gloo"],
                    default="nccl",
                    help="the ranks' torch.distributed backend (gloo puts "
                    "several ranks on one card, through the host)")
    return ap


def main(argv: list[str] | None = None) -> list[Request] | LoadResult:
    """Serve the fixed request list (returns the requests) or, with
    ``--scenario``, replay the scenario (returns the :class:`LoadResult`).
    With ``--mesh``: rank 0's requests."""
    args = _parser().parse_args(argv)
    if args.mesh is None:
        return _serve(args, resolve_device(args.device))
    from repro_torch.launch.mesh import run_ranks

    if args.scenario or args.draft or args.prefix_cache:
        raise SystemExit("[serve] --mesh serves the fixed request list, "
                         "without --scenario, --draft or --prefix-cache")
    if resolve_device(args.device).type == "cuda":
        from repro_torch.kernels import _build

        # once, before the ranks start: each rank loads the libraries
        _build.build_all(_build.MODEL_SOURCES)
    return run_ranks(serve_rank, args.mesh, backend=args.dist_backend,
                     device=args.device, args=(args,))[0]


def serve_rank(mesh, device: torch.device, args: argparse.Namespace):
    """One rank of ``--mesh``: the launcher's serving on ``mesh``, printed
    by rank 0 only."""
    if mesh.index(mesh.axis_names) == 0:
        return _serve(args, device, mesh)
    with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
        return _serve(args, device, mesh)


def _serve(args: argparse.Namespace, device: torch.device, mesh=None):
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.act_dtype != "none":
        cfg = cfg.with_(act_dtype=args.act_dtype)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    served = init_serving_params(cfg, gen, device)
    print(f"[serve] {cfg.name} on {device}: packed "
          f"{packed_bits_per_weight(served):.3f} b/w")
    draft = None
    if args.draft:
        dcfg = (get_smoke_config(args.draft) if args.smoke
                else get_config(args.draft))
        dgen = torch.Generator(device=device).manual_seed(args.seed + 1)
        dserved = init_serving_params(dcfg, dgen, device)
        print(f"[serve] draft {dcfg.name}: spec_k={args.spec_k}, packed "
              f"{packed_bits_per_weight(dserved):.3f} b/w")
        draft = (dserved, dcfg)
    scenario = None
    if args.scenario:
        scenario = get_scenario(args.scenario)
        if args.smoke:
            scenario = scenario.smoke()
        need = scenario_max_len(scenario, args.max_len)
        if need != args.max_len:  # the scenario dictates the geometry
            args.max_len = need
            print(f"[serve] scenario {scenario.name}: max_len raised to "
                  f"{args.max_len}")
    engine = DecodeEngine(served, cfg, batch_size=args.batch,
                          max_len=args.max_len, matmul_policy=args.policy,
                          prefill_chunk=args.prefill_chunk, device=device,
                          prefix_cache=args.prefix_cache,
                          prefix_cache_mb=args.prefix_cache_mb,
                          draft=draft, spec_k=args.spec_k, mesh=mesh)
    del served   # a mesh's engine keeps its slice
    if mesh is not None:
        print(f"[serve] mesh {mesh.name} ({mesh.backend}), {mesh.size} ranks; "
              f"rank 0's slice: packed {packed_bits_per_weight(engine.params):.3f}"
              f" b/w")
    budget = args.admission_budget if args.admission_budget > 0 else None
    if args.autotune:
        for shape, us in engine.autotune_shapes().items():
            print(f"[autotune] M{shape[0]} K{shape[1]} N{shape[2]}: "
                  + ", ".join(f"{k} {t:.1f}us" for k, t in sorted(
                      us.items(), key=lambda kv: kv[1])))
    if scenario is not None:
        trace = generate_trace(scenario, cfg.vocab_size, args.scenario_seed)
        reset_launch_counts()
        res = LoadGenerator(engine, trace, clock="wall",
                            admission_budget=budget,
                            dynamic_spec_k=args.dynamic_spec_k).run()
        print(f"[serve] scenario {scenario.name} (seed "
              f"{args.scenario_seed}): {len(res.records)} requests, "
              f"offered {res.offered_qps:.2f} qps, achieved "
              f"{res.achieved_qps:.2f} qps, makespan {res.makespan_s:.2f}s, "
              f"{res.emitted_tokens} tokens / {res.stats.decode_steps} "
              f"decode steps; kernel launches: {_launch_report()}")
        _print_tenant_lines(scenario, res)
        _print_spec_line(engine, res.stats, res.emitted_tokens)
        _print_prefix_line(engine)
        return res

    n_req = args.requests if args.requests is not None else args.batch
    plen = max(2, min_prompt_len(cfg))
    reqs = [Request(prompt=[7 + i + 6 * j for j in range(plen)],
                    max_new_tokens=args.new_tokens) for i in range(n_req)]

    reset_launch_counts()
    t0 = time.perf_counter()
    if args.discipline == "generational":
        if n_req > args.batch:
            raise SystemExit("[serve] generational cannot queue: "
                             "--requests must be <= --batch")
        engine.run(reqs)
        steps = max(len(r.out) for r in reqs)
    else:
        sched = ContinuousScheduler(engine, admission_budget=budget,
                                    dynamic_spec_k=args.dynamic_spec_k)
        for r in reqs:
            sched.submit(r)
        sched.run()
        steps = sched.stats.decode_steps
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    n = sum(len(r.out) for r in reqs)
    print(f"[serve] {args.discipline}: {n} tokens / {steps} decode steps in "
          f"{dt:.2f}s ({n / dt:.1f} tok/s); kernel launches: "
          f"{_launch_report()}")
    if mesh is not None:
        st = mesh.stats
        print(f"[serve] rank 0 collectives ({mesh.backend}): {st.calls} "
              f"calls, {st.bytes / 1e6:.3f} MB joined, "
              f"{st.seconds * 1e3:.1f} ms")
    if args.discipline == "continuous":
        _print_spec_line(engine, sched.stats, n)
    _print_prefix_line(engine)
    for i, r in enumerate(reqs):
        print(f"  [{i}] {r.out}")
    return reqs


def _launch_report() -> str:
    return ", ".join(f"{k} {v}" for k, v in launch_counts().items())


def scenario_max_len(scenario, max_len: int) -> int:
    """``max_len`` raised, if it must be, to hold the scenario's longest
    prompt plus its longest answer (rounded up to a multiple of 16)."""
    need = scenario.max_prompt_len() + scenario.max_new_tokens() + 1
    return max_len if max_len >= need else -(-need // 16) * 16


def tenant_lines(scenario, res: LoadResult) -> dict:
    """Per tenant: request count, TTFT and TPOT summaries (seconds), and the
    share of requests within both of the tenant's SLOs."""
    tenants = {t.name: t for t in scenario.tenants}
    out = {}
    for name, recs in sorted(res.by_tenant().items()):
        ten = tenants[name]
        ok = sum(1 for r in recs
                 if r.ttft_s is not None and r.ttft_s <= ten.slo_ttft_s
                 and (r.tpot_s is None or r.tpot_s <= ten.slo_tpot_s))
        out[name] = {
            "requests": len(recs),
            "ttft_s": latency_summary(
                [r.ttft_s for r in recs if r.ttft_s is not None]),
            "tpot_s": latency_summary(
                [r.tpot_s for r in recs if r.tpot_s is not None]),
            "queue_wait_s": latency_summary(
                [r.queue_wait_s for r in recs if r.queue_wait_s is not None]),
            "slo_attainment": ok / len(recs)}
    return out


def _print_tenant_lines(scenario, res: LoadResult) -> None:
    for name, t in tenant_lines(scenario, res).items():
        ttft, tpot = t["ttft_s"], t["tpot_s"]
        print(f"[serve]   {name}: {t['requests']} reqs | ttft p50/p95/p99 "
              f"{ttft['p50']:.4f}/{ttft['p95']:.4f}/{ttft['p99']:.4f}s | "
              f"tpot p50 {tpot['p50']:.4f}s | slo attainment "
              f"{t['slo_attainment']:.0%}")


def _print_spec_line(engine: DecodeEngine, st, tokens: int) -> None:
    if not engine.spec_k:
        return
    print(f"[serve] speculative: {st.spec_rounds} rounds, "
          f"{st.accepted_drafted_tokens}/{st.drafted_tokens} drafted tokens "
          f"accepted ({st.acceptance_rate:.0%}), "
          f"{tokens / max(st.decode_steps, 1):.2f} tok/decode-step")


def _print_prefix_line(engine: DecodeEngine) -> None:
    store = engine.prefix_store
    if store is None:
        return
    st = store.stats
    print(f"[serve] prefix cache: {st.hit_blocks}/{st.lookups} block hits "
          f"({st.hit_rate:.0%}), {st.reused_tokens} prompt tokens spliced, "
          f"{st.published_blocks} published, {st.evicted_blocks} evicted, "
          f"{len(store)} blocks resident ({store.nbytes >> 10} KiB)")


if __name__ == "__main__":
    main()
