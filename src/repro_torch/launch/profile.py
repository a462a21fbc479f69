"""Device trace of serving decode steps: where one step's time goes.

Builds the engine as ``launch.serve`` does (random weights from a seed,
packed layer by layer, every slot admitted), then runs ``--steps`` decode
steps under ``torch.profiler`` (the card's activity) and prints one
JSON line:
wall time per step, device busy time per step (the summed device time of
every kernel and copy on the card), the device's idle share, kernel launches
per step, the launches of each hand kernel per step, and the kernels that
take the most device time.  ``--scenario NAME`` sizes the KV ring as
``launch.serve --scenario`` does (max_len raised to the scenario's longest
prompt plus its longest answer), so a step attends the ring it would
attend under that traffic.

Usage (on the card):
  python -m repro_torch.launch.profile --arch bitnet-b1.58-2b --batch 4 \
      [--steps 8] [--act-dtype none|int8] [--policy auto] [--smoke] \
      [--scenario chat|rag|agentic|code]
  python -m repro_torch.launch.profile --arch phi3.5-moe-42b-a6.6b --batch 4
  python -m repro_torch.launch.profile --arch zamba2-2.7b --batch 4
  python -m repro_torch.launch.profile --arch llama4-maverick-400b-a17b \
      --n-layers 8 --batch 4
  python -m repro_torch.launch.profile --arch bitnet-b1.58-2b --train \
      --global-batch 8 --seq-len 512 --steps 3

``--train`` traces QAT train steps (``launch.train.make_train_step``)
instead: the same breakdown per step, tokens/s and the peak memory.

(zamba2-2.7b, xlstm-125m, whisper-large-v3, internvl2-2b and
llama4-maverick admit each
slot's prompt through one whole-prompt prefill; each slot's prompt is 8
tokens, or internvl2's 64 vision positions.)
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
from repro_torch.launch.serve import scenario_max_len
from repro_torch.models.decode import init_serving_params, min_prompt_len
from repro_torch.serving.engine import DecodeEngine, Request
from repro_torch.serving.workload import get_scenario


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
    steps.  Returns the per-step breakdown.  The trace holds the card's
    activity only, all the breakdown reads (the host's ops too would
    multiply the time a trace takes, for the same busy ms)."""
    state = engine.sched_start()
    for slot in range(engine.B):
        req = Request(prompt=list(range(2 + slot, 2 + slot + prompt_len)),
                      max_new_tokens=steps + 4)
        state = engine.sched_admit(state, slot, req)
    for _ in range(2):
        state, _, _ = engine.sched_step(state)
    torch.cuda.synchronize()
    reset_launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _, _ = engine.sched_step(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return _breakdown(prof, wall, steps)


def profile_train(cfg, device, steps: int, global_batch: int, seq_len: int,
                  seed: int = 0) -> dict:
    """Two warm-up QAT train steps (``launch.train.make_train_step``, the
    config's optimizer) from a seeded init, then ``steps`` traced ones:
    the per-step breakdown, tokens/s and the peak device memory."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLMStream
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.model import init_params
    from repro_torch.optim.optimizers import make_optimizer

    torch.cuda.reset_peak_memory_stats(device)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(seed),
                         device)
    opt = make_optimizer(cfg.optimizer, warmup=2, total=steps + 2)
    state = opt.init(params)
    step_fn = make_train_step(cfg, opt)
    data = SyntheticLMStream(DataConfig(cfg.vocab_size, seq_len,
                                        global_batch))

    def run(i):
        nonlocal params, state
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in data.batch(i).items()}
        params, state, _, _ = step_fn(params, state, {}, batch, i)

    for i in range(2):
        run(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(2, 2 + steps):
            run(i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = _breakdown(prof, wall, steps)
    out.pop("hand_kernel_launches_per_step")
    return {**out, "global_batch": global_batch, "seq_len": seq_len,
            "tokens_per_s": global_batch * seq_len * steps / wall,
            "max_memory_allocated_gb":
                torch.cuda.max_memory_allocated(device) / 1e9}


def _breakdown(prof, wall: float, steps: int) -> dict:
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
    ap.add_argument("--scenario", default=None,
                    help="size max_len from this workload's geometry, as "
                    "launch.serve --scenario does (default 256)")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the depth (llama4-maverick does not fit one "
                    "card at its 48)")
    ap.add_argument("--train", action="store_true",
                    help="trace QAT train steps instead of decode steps")
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=512)
    args = ap.parse_args(argv)

    device = resolve_device("cuda")
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.act_dtype != "none":
        cfg = cfg.with_(act_dtype=args.act_dtype)
    if args.n_layers:
        cfg = cfg.with_(n_layers=args.n_layers)
    if args.train:
        out = {"arch": cfg.name, "n_layers": cfg.n_layers, "train": True,
               "optimizer": cfg.optimizer,
               "gpu": torch.cuda.get_device_name(device),
               **profile_train(cfg, device, args.steps, args.global_batch,
                               args.seq_len, args.seed)}
        print(json.dumps(out), flush=True)
        return out
    gen = torch.Generator(device=device).manual_seed(args.seed)
    served = init_serving_params(cfg, gen, device)
    max_len = 256
    if args.scenario:
        scenario = get_scenario(args.scenario)
        if args.smoke:
            scenario = scenario.smoke()
        max_len = scenario_max_len(scenario, max_len)
    engine = DecodeEngine(served, cfg, batch_size=args.batch,
                          max_len=max_len, matmul_policy=args.policy,
                          device=device)
    out = {"arch": cfg.name, "n_layers": cfg.n_layers, "batch": args.batch,
           "max_len": max_len,
           "act_dtype": cfg.act_dtype,
           "policy": args.policy or "auto",
           "gpu": torch.cuda.get_device_name(device),
           **profile_steps(engine, args.steps,
                           max(8, min_prompt_len(cfg)))}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
