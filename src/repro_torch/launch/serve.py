"""Serving launcher: build a model's packed 1.6-bit serving weights from a
seed, layer by layer, and serve generation through the continuous-batching
scheduler on the card.

Usage:
  python -m repro_torch.launch.serve --arch bitnet-b1.58-2b [--smoke] \
      [--batch 4] [--max-len 256] [--requests N] [--new-tokens 32] \
      [--prefill-chunk 32] [--act-dtype none|int8] [--policy auto] \
      [--autotune] [--device cuda|cpu] [--seed 0]

``--arch`` takes bitnet-b1.58-2b or phi3.5-moe-42b-a6.6b (16 experts,
top-2, an MoE FFN on every layer).  Weights are random (there is no
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
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.kernels.dispatch import launch_counts, reset_launch_counts
from repro_torch.models.decode import (init_serving_params,
                                       packed_bits_per_weight)
from repro_torch.serving.engine import DecodeEngine, Request
from repro_torch.serving.scheduler import ContinuousScheduler


def main(argv: list[str] | None = None) -> list[Request]:
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
    ap.add_argument("--act-dtype", choices=["none", "int8"], default="none",
                    help="int8 quantizes activations per token in front of "
                    "every packed matmul (the W1.58A8 path)")
    ap.add_argument("--policy", default=None,
                    help="ternary-matmul policy: auto | prior | "
                    "fixed:<kernel> (default: auto)")
    ap.add_argument("--autotune", action="store_true",
                    help="time every eligible kernel at the engine's shapes "
                    "before serving, so 'auto' dispatches on measurements")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (plain PyTorch kernels)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.act_dtype != "none":
        cfg = cfg.with_(act_dtype=args.act_dtype)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    served = init_serving_params(cfg, gen, device)
    print(f"[serve] {cfg.name} on {device}: packed "
          f"{packed_bits_per_weight(served):.3f} b/w")
    engine = DecodeEngine(served, cfg, batch_size=args.batch,
                          max_len=args.max_len, matmul_policy=args.policy,
                          prefill_chunk=args.prefill_chunk, device=device)
    if args.autotune:
        for shape, us in engine.autotune_shapes().items():
            print(f"[autotune] M{shape[0]} K{shape[1]} N{shape[2]}: "
                  + ", ".join(f"{k} {t:.1f}us" for k, t in sorted(
                      us.items(), key=lambda kv: kv[1])))
    n_req = args.requests if args.requests is not None else args.batch
    reqs = [Request(prompt=[7 + i, 13 + i], max_new_tokens=args.new_tokens)
            for i in range(n_req)]

    reset_launch_counts()
    t0 = time.perf_counter()
    sched = ContinuousScheduler(engine)
    for r in reqs:
        sched.submit(r)
    sched.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    n = sum(len(r.out) for r in reqs)
    launches = ", ".join(f"{k} {v}" for k, v in launch_counts().items())
    print(f"[serve] {n} tokens / {sched.stats.decode_steps} decode steps in "
          f"{dt:.2f}s ({n / dt:.1f} tok/s); kernel launches: {launches}")
    for i, r in enumerate(reqs):
        print(f"  [{i}] {r.out}")
    return reqs


if __name__ == "__main__":
    main()
