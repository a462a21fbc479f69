"""Where speculative verify and sequential decode part on the card.

    PYTHONPATH=src python -m repro_torch.launch.verify_drift \
        [--arch bitnet-b1.58-2b] [--batch 4] [--spec-k 4] [--seed 0] \
        [--smoke --device cpu]

Builds the model at full width from the seed (layer by layer), admits
``--batch`` prompts of 3, 40, 17 and 64 tokens (cycled) on the prior, and
draws ``--spec-k`` random candidates a row.  Then, on the card:

  * each op class at the verify's row count (``batch x spec_k`` rows, or
    ``spec_k`` queries a row in one call) against the same rows at
    decode's (``batch`` rows a call, one query a row), on ``TRIALS`` random
    inputs: the f32 sums of each dense ternary kernel of one layer (the
    prior's pick, before the scale and the bf16 rounding), the LM head,
    the RMS norm's mean, and the scatter-first attention, in one call and
    with each query a batch row of its own; a line each with the rows
    that are bitwise equal and the largest difference;
  * ``verify_step`` against ``spec_k`` sequential ``decode_step`` calls on
    ``E2E_TRIALS`` candidate sets, as the port runs it (each projection
    launched per position, each query a batch row), with the projections
    in one call, with the attention's queries in one call, and with both:
    logits' largest difference, positions bitwise equal, and positions
    whose canonical greedy token (argmax over bf16-rounded logits) agrees.

One JSON line each; the card's name and power limit first.  ``--smoke
--device cpu`` runs the reduced config on the CPU to try the script; its
numbers say nothing of the card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from contextlib import contextmanager, nullcontext

import torch

from repro_torch.device import resolve_device


#: random inputs each op class is compared on
TRIALS = 16
#: candidate sets verify is held against sequential decode on
E2E_TRIALS = 4


def _line(**fields) -> None:
    print(json.dumps(fields), flush=True)


def _rows(full: torch.Tensor, parts: torch.Tensor) -> dict:
    """Compare ``full`` and ``parts`` (the same shape) row by row over the
    last dimension."""
    f, p = full.float().flatten(0, -2), parts.float().flatten(0, -2)
    equal = (f == p).all(-1)
    return {"rows": int(equal.numel()), "rows_bitwise_equal":
            int(equal.sum()), "max_abs_diff": float((f - p).abs().max())}


@contextmanager
def _patched(module, name, fn):
    old = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, old)


def main(argv: list[str] | None = None) -> None:
    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.kernels.dispatch import select_kernel
    from repro_torch.models import decode, layers, model
    from repro_torch.serving.engine import DecodeEngine, Request, greedy_tokens

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="bitnet-b1.58-2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--spec-k", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    if dev.type == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, check=True).stdout.strip()
        _line(gpu=card, device=torch.cuda.get_device_name(0))
    B, K = args.batch, args.spec_k
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    served = decode.init_serving_params(cfg, gen, dev)
    eng = DecodeEngine(served, cfg, batch_size=B, max_len=256,
                       prefill_chunk=32, device=dev)
    g = torch.Generator(device=dev).manual_seed(args.seed + 1)
    state = eng.sched_start()
    for slot in range(B):
        n = (3, 40, 17, 64)[slot % 4]
        prompt = torch.randint(2, cfg.vocab_size, (n,), generator=g,
                               device=dev).tolist()
        state = eng.sched_admit(state, slot, Request(prompt=prompt))
    cache, start = state["cache"], state["index"] + 1
    cands = torch.randint(2, cfg.vocab_size, (B, K), generator=g, device=dev)
    p = eng.params
    blk = p["blocks"][0]
    D = cfg.d_model

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=torch.bfloat16)

    orig_sdpa = layers._sdpa

    def queries_as_rows(qq, k_, v_, c, *, q_pos, k_pos, extra_kv=None,
                        **kw):
        """The verify's attention as the port runs it: each query a batch
        row of its own, the cache repeated per query."""
        Bq, S = qq.shape[:2]

        def rows(t):
            return t.reshape(Bq * S, 1, *t.shape[2:])

        def rep(t):
            return t.repeat_interleave(S, 0)

        out = orig_sdpa(rows(qq), rep(k_), rep(v_), c,
                        q_pos=q_pos.reshape(Bq * S, 1), k_pos=rep(k_pos),
                        extra_kv=tuple(rows(t) for t in extra_kv), **kw)
        return out.reshape(Bq, S, -1)

    # -- each op class at the verify's row count vs decode's --------------
    def trials(fn):
        """``fn()`` → (full, parts) on fresh random inputs, ``TRIALS``
        times, compared row by row."""
        got = [_rows(*fn()) for _ in range(TRIALS)]
        return {"trials": TRIALS, "rows": sum(x["rows"] for x in got),
                "rows_bitwise_equal": sum(x["rows_bitwise_equal"]
                                          for x in got),
                "max_abs_diff": max(x["max_abs_diff"] for x in got)}

    for path in (("attn", "wq"), ("attn", "wk"), ("attn", "wo"),
                 ("ffn", "wi"), ("ffn", "wo")):
        tw = blk[path[0]][path[1]]["tw"]
        k_in = tw.in_features
        kern = select_kernel(B * K, k_in, tw.out_features, "bfloat16",
                             device=dev.type)
        kern_b = select_kernel(B, k_in, tw.out_features, "bfloat16",
                               device=dev.type)

        def proj():
            x = randn(B, K, k_in)
            return (kern.run(x.reshape(B * K, k_in), tw, 3).reshape(B, K, -1),
                    torch.stack([kern_b.run(x[:, j].contiguous(), tw, 3)
                                 for j in range(K)], 1))

        # the kernels' f32 sums, before the scale and the bf16 rounding
        _line(op="ternary_matmul_f32", proj=".".join(path),
              kernel=kern.name, kernel_at_decode=kern_b.name,
              M_verify=B * K, M_decode=B, **trials(proj))
    w = model.lm_head_w(p, cfg)

    def head():
        h = randn(B, K, D)
        return h @ w, torch.stack([h[:, j] @ w for j in range(K)], 1)

    def norm():
        h = randn(B, K, D).float()
        parts = [h[:, j:j + 1].contiguous() for j in range(K)]
        return ((h * h).mean(-1, keepdim=True),
                torch.cat([(x * x).mean(-1, keepdim=True) for x in parts], 1))

    _line(op="lm_head_bf16", **trials(head))
    _line(op="rms_norm_mean_f32", **trials(norm))
    positions = decode._window_positions(start, K)
    CL = cache["pos"].shape[-1]
    keep, r, s = layers.ring_writes(decode._ring_slot(cfg, CL, positions), CL)
    k_pos = cache["pos"][0].clone()
    k_pos[r, s] = positions[keep]

    def attention(form):
        q = randn(B, K, cfg.n_heads, cfg.head_dim)
        kk = randn(B, K, cfg.n_kv_heads, cfg.head_dim)
        vv = randn(B, K, cfg.n_kv_heads, cfg.head_dim)
        ck, cv = cache["k"][0].clone(), cache["v"][0].clone()
        ck[r, s], cv[r, s] = kk[keep], vv[keep]
        args = (ck, cv, cfg)
        kw = dict(kind="causal_strict", extra_kind="self")
        per_query = torch.cat([orig_sdpa(
            q[:, j:j + 1], *args, q_pos=positions[:, j:j + 1], k_pos=k_pos,
            extra_kv=(kk[:, j:j + 1], vv[:, j:j + 1], positions[:, j:j + 1]),
            **kw) for j in range(K)], 1)
        fn = orig_sdpa if form == "batched" else queries_as_rows
        return fn(q, *args, q_pos=positions, k_pos=k_pos,
                  extra_kv=(kk, vv, positions), **kw), per_query

    _line(op="attention_bf16", form="queries_batched_in_one_call",
          **trials(lambda: attention("batched")))
    _line(op="attention_bf16", form="queries_as_batch_rows",
          **trials(lambda: attention("as_rows")))

    # -- end to end ----------------------------------------------------------
    def sequential(c):
        seq = {n: t.clone() for n, t in cache.items()}
        out = []
        for j in range(K):
            logits, seq = decode.decode_step(p, cfg, seq, c[:, j], start + j)
            out.append(logits)
        return torch.stack(out, 1), seq

    def attention_in_one_call(qq, k_, v_, c, *, q_pos, k_pos, extra_kv=None,
                              **kw):
        """The verify's attention with its ``K`` queries a row in one call
        (the cache not repeated per query), as batched attention runs it."""
        if qq.shape[1] != 1 or k_.shape[0] != B * K:
            return orig_sdpa(qq, k_, v_, c, q_pos=q_pos, k_pos=k_pos,
                             extra_kv=extra_kv, **kw)

        def grouped(t):
            return t.reshape(B, K, *t.shape[2:])

        out = orig_sdpa(grouped(qq), k_[::K], v_[::K], c,
                        q_pos=grouped(q_pos), k_pos=k_pos[::K],
                        extra_kv=tuple(grouped(t) for t in extra_kv), **kw)
        return out.reshape(B * K, 1, -1)

    one_call_projections = (decode, "per_position_launches", nullcontext)
    one_call_attention = (layers, "_sdpa", attention_in_one_call)
    variants = [
        ("as_served", []),
        ("projections_in_one_call", [one_call_projections]),
        ("attention_in_one_call", [one_call_attention]),
        ("both_in_one_call", [one_call_projections, one_call_attention]),
    ]
    cand_sets = [torch.randint(2, cfg.vocab_size, (B, K), generator=g,
                               device=dev) for _ in range(E2E_TRIALS)]
    cand_sets[0] = cands
    refs = [sequential(c) for c in cand_sets]
    for name, patches in variants:
        rows = equal = greedy = 0
        diff = kv_diff = 0.0
        for c, (seq_logits, seq) in zip(cand_sets, refs):
            ctx = [_patched(*pt) for pt in patches]
            for cm in ctx:
                cm.__enter__()
            try:
                vlogits, vcache = decode.verify_step(
                    p, cfg, {n: t.clone() for n, t in cache.items()}, c,
                    start)
            finally:
                for cm in reversed(ctx):
                    cm.__exit__(None, None, None)
            got = _rows(vlogits, seq_logits)
            rows += got["rows"]
            equal += got["rows_bitwise_equal"]
            diff = max(diff, got["max_abs_diff"])
            kv_diff = max(kv_diff, *(float((vcache[n].float()
                                           - seq[n].float()).abs().max())
                                     for n in ("k", "v")))
            greedy += int((greedy_tokens(vlogits)
                           == greedy_tokens(seq_logits)).sum())
        _line(op="verify_vs_decode", variant=name, trials=E2E_TRIALS,
              positions=rows, positions_bitwise_equal=equal,
              max_abs_diff=diff, kv_max_abs_diff=kv_diff,
              greedy_equal=greedy)


if __name__ == "__main__":
    main()
