"""Fault-tolerant training loop on one device (QAT with straight-through
fake-quant; the reference's ``launch/train.py`` without the mesh).

  * **checkpoint/restart**: async atomic checkpoints every
    ``--checkpoint-every`` steps and a final one; ``--resume auto`` restores
    the latest committed step (crc-validated) and the data stream realigns
    to it (the pipeline is a pure function of the step);
  * **straggler watchdog**: a step over ``deadline_factor`` times the
    trailing median step time is a strike; after ``max_straggler_strikes``
    the loop checkpoints and exits (``main`` with code 17) so a scheduler
    can reschedule;
  * **gradient compression**: optional int8 error-feedback round trip
    (``--compress-grads``, ``optim/compression.py``);
  * **NaN containment**: a step whose loss or gradient norm is not finite
    leaves the parameters and optimizer state as they were, decided on the
    device (``torch.where``, no read back to the host).

    python -m repro_torch.launch.train --arch bitnet-b1.58-2b --smoke \\
        --device cpu --steps 20 --ckpt-dir /tmp/ckpt

runs on the CPU; without ``--device cpu`` it trains on the card.  The
QAT forward computes its products with ``torch.matmul`` (the reference's
run in XLA outside its kernels); the trained weights reach the hand
kernels through ``decode.quantize_for_serving``.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time

import torch

from repro_torch.checkpoint import checkpointing as ckpt
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.data.pipeline import DataConfig, SyntheticLMStream
from repro_torch.device import resolve_device
from repro_torch.models.model import init_params, train_loss
from repro_torch.optim import compression
from repro_torch.optim.optimizers import (clip_by_global_norm, make_optimizer,
                                          tree_leaves, tree_unflatten)


def make_train_step(cfg, opt, compress: bool = False):
    """``train_step(params, opt_state, err_state, batch, step) -> (params,
    opt_state, err_state, metrics)``: value and gradient of
    ``train_loss``, the optional compression round trip, clipping to a
    global norm of 1.0 and the optimizer update, skipped on the device when
    the loss or the norm is not finite.  ``params`` and ``opt_state`` are
    updated in place (the reference donates their buffers) and returned;
    ``err_state`` is replaced.  ``metrics`` are 0-d tensors: loss, gnorm,
    skipped, ce, aux."""
    def train_step(params, opt_state, err_state, batch, step):
        leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
        loss, metrics = train_loss(tree_unflatten(params, leaves), cfg, batch)
        grads = tree_unflatten(params, torch.autograd.grad(loss, leaves))
        loss, metrics = loss.detach(), {k: v.detach()
                                        for k, v in metrics.items()}
        del leaves
        if compress:
            grads, err_state = compression.roundtrip(grads, err_state)
        grads, gnorm = clip_by_global_norm(grads, 1.0)
        ok = torch.isfinite(loss) & torch.isfinite(gnorm)
        params, opt_state = opt.update(opt_state, grads, params, step, ok)
        return params, opt_state, err_state, {
            "loss": loss, "gnorm": gnorm,
            "skipped": (~ok).to(torch.float32), **metrics}
    return train_step


def train(cfg, *, steps: int, global_batch: int, seq_len: int,
          ckpt_dir: str | None = None, checkpoint_every: int = 50,
          resume: str = "auto", compress_grads: bool = False,
          deadline_factor: float = 3.0, max_straggler_strikes: int = 5,
          log_every: int = 10, lr: float = 3e-4, warmup: int = 100,
          device: str | torch.device | None = None, save_final: bool = True):
    """Train ``cfg`` from random weights (``init_params`` from seed 0) on
    the synthetic stream for steps ``[start, steps)``, checkpointing into
    ``ckpt_dir`` every ``checkpoint_every`` steps and, unless
    ``save_final`` is off, after the last.  Returns ``{"exit": "done" |
    "straggler", "step", "history": losses, "records": per step {step,
    loss, gnorm, ms, skipped}, "params"}``."""
    dev = resolve_device(device)
    opt = make_optimizer(cfg.optimizer, base_lr=lr, warmup=warmup,
                         total=steps)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen, dev)
    opt_state = opt.init(params)
    err_state = compression.init_error_state(params) if compress_grads else {}

    start_step = 0
    if ckpt_dir and resume == "auto":
        latest = ckpt.latest_step(ckpt_dir)
        if latest is not None:
            state = ckpt.restore(ckpt_dir, latest,
                                 {"params": params, "opt": opt_state})
            params, opt_state = state["params"], state["opt"]
            start_step = latest + 1
            print(f"[train] resumed from step {latest}")

    data = SyntheticLMStream(DataConfig(cfg.vocab_size, seq_len,
                                        global_batch))
    step_fn = make_train_step(cfg, opt, compress_grads)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    times, strikes = [], 0
    history, records = [], []
    for step in range(start_step, steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in data.batch(step).items()}
        sync()
        t0 = time.perf_counter()
        params, opt_state, err_state, metrics = step_fn(
            params, opt_state, err_state, batch, step)
        sync()
        dt = time.perf_counter() - t0
        if len(times) >= 5:
            med = statistics.median(times[-20:])
            if dt > deadline_factor * med:
                strikes += 1
                print(f"[train] straggler: step {step} took {dt:.2f}s "
                      f"(median {med:.2f}s) — strike {strikes}")
                if strikes >= max_straggler_strikes:
                    if ckpt_dir:
                        ckpt.save(ckpt_dir, step,
                                  {"params": params, "opt": opt_state})
                    print("[train] too many stragglers; checkpointed, "
                          "exiting for reschedule")
                    return {"exit": "straggler", "step": step,
                            "history": history, "records": records}
        times.append(dt)
        loss, gnorm = float(metrics["loss"]), float(metrics["gnorm"])
        skipped = bool(float(metrics["skipped"]))
        history.append(loss)
        records.append({"step": step, "loss": loss, "gnorm": gnorm,
                        "ms": dt * 1e3, "skipped": skipped})
        if step % log_every == 0 or step == steps - 1:
            print(f"[train] step {step:5d} loss {loss:.4f} gnorm {gnorm:.3f} "
                  f"{dt * 1e3:.0f}ms" + (" SKIPPED" if skipped else ""))
        if ckpt_dir and (step + 1) % checkpoint_every == 0:
            ckpt.save_async(ckpt_dir, step, {"params": params,
                                             "opt": opt_state})
    ckpt.wait()
    if ckpt_dir and save_final:
        ckpt.save(ckpt_dir, steps - 1, {"params": params, "opt": opt_state})
    return {"exit": "done", "step": steps - 1, "history": history,
            "records": records, "params": params}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-friendly)")
    ap.add_argument("--ckpt-dir")
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--resume", default="auto", choices=["auto", "none"])
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    out = train(cfg, steps=args.steps, global_batch=args.global_batch,
                seq_len=args.seq_len, ckpt_dir=args.ckpt_dir,
                checkpoint_every=args.checkpoint_every, resume=args.resume,
                compress_grads=args.compress_grads, lr=args.lr,
                device=args.device)
    sys.exit(0 if out["exit"] == "done" else 17)


if __name__ == "__main__":
    main()
