"""Device trace of serving decode steps: where one step's time goes.

Builds the engine as ``launch.serve`` does (random weights from a seed,
packed layer by layer, every slot admitted), then runs ``--steps`` decode
steps under ``torch.profiler`` with CPU and CUDA activities and prints one
JSON line:
wall time per step, device busy time per step (the summed device time of
every kernel and copy on the card), the device's idle share, kernel launches
per step, the launches of each hand kernel per step, and the kernels that
take the most device time.

Usage (on the card):
  python -m repro_torch.launch.profile --arch bitnet-b1.58-2b --batch 4 \
      [--steps 8] [--act-dtype none|int8] [--policy auto] [--smoke]
  python -m repro_torch.launch.profile --arch phi3.5-moe-42b-a6.6b --batch 4
"""

from __future__ import annotations

import argparse
import json
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.kernels.dispatch import launch_counts, reset_launch_counts
from repro_torch.models.decode import init_serving_params
from repro_torch.serving.engine import DecodeEngine, Request


def _self_device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        value = getattr(evt, name, None)
        if value is not None:
            return float(value)
    return 0.0


def _on_device(evt) -> bool:
    """A kernel (or copy) that ran on the card, not the CPU op that launched
    it: the CPU op's self device time repeats its kernels' time."""
    return evt.device_type != DeviceType.CPU and _self_device_us(evt) > 0


def profile_steps(engine: DecodeEngine, steps: int, prompt_len: int = 8) -> dict:
    """Admit one request per slot, warm up, and trace ``steps`` decode
    steps.  Returns the per-step breakdown."""
    state = engine.sched_start()
    for slot in range(engine.B):
        req = Request(prompt=list(range(2 + slot, 2 + slot + prompt_len)),
                      max_new_tokens=steps + 4)
        state = engine.sched_admit(state, slot, req)
    for _ in range(2):
        state, _, _ = engine.sched_step(state)
    torch.cuda.synchronize()
    reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _, _ = engine.sched_step(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if _on_device(e)]
    busy_us = sum(_self_device_us(e) for e in kernels)
    top = sorted(kernels, key=_self_device_us, reverse=True)[:10]
    return {
        "steps": steps,
        "wall_ms_per_step": wall / steps * 1e3,
        "device_busy_ms_per_step": busy_us / steps / 1e3,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall,
        "kernel_launches_per_step": sum(e.count for e in kernels) / steps,
        "hand_kernel_launches_per_step": {
            k: v / steps for k, v in launch_counts().items()},
        "top_kernels": [{"name": e.key[:160], "count": e.count,
                         "ms_per_step": _self_device_us(e) / steps / 1e3}
                        for e in top],
    }


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--act-dtype", choices=["none", "int8"], default="none")
    ap.add_argument("--policy", default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device("cuda")
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.act_dtype != "none":
        cfg = cfg.with_(act_dtype=args.act_dtype)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    served = init_serving_params(cfg, gen, device)
    engine = DecodeEngine(served, cfg, batch_size=args.batch, max_len=256,
                          matmul_policy=args.policy, device=device)
    out = {"arch": cfg.name, "batch": args.batch, "act_dtype": cfg.act_dtype,
           "policy": args.policy or "auto",
           "gpu": torch.cuda.get_device_name(device),
           **profile_steps(engine, args.steps)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
