"""Device time of the LUT kernels (``lut_gather``, ``lut_onehot``) at one
bitnet layer's projection shapes, fed as served, beside the bf16
``torch.matmul`` yardstick on the same inputs.

Each call's time is from a cold L2 (:func:`repro_torch.kernels.dispatch.cold_times_ms`,
the timer chip_smoke and autotune use), the mean of ``--reps`` calls.  One
JSON line per (kernel, M, activation dtype): the per-shape means in µs and
the layer's sum in ms; first the card's name and power limit and its SM
clock now and at most.

Usage (on the card):
  python -m repro_torch.launch.lut_times [--m 4 32] [--act bfloat16 float32]

To compare two checkouts' kernels on the same inputs in one call, run this
file with ``PYTHONPATH`` set to each checkout's ``src`` in turn (the
script itself imports only ``repro_torch``), e.g. parent, change, change,
parent.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

#: one bitnet-b1.58-2b layer: (K, N) of its projections and how many of each
LAYER_KN = {(2560, 2560): 2, (2560, 640): 2, (2560, 6912): 2, (6912, 2560): 1}
SEED = 0


def _smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def time_layer(name: str, m: int, act: str, reps: int,
               flush: torch.Tensor) -> dict:
    from repro_torch.kernels import lut_matmul as lut
    from repro_torch.kernels.dispatch import TernaryWeight, cold_times_ms

    fn = lut.lut_matmul if name == "lut_gather" else lut.lut_onehot_matmul
    dev = torch.device("cuda")
    shapes, total, library = {}, 0.0, 0.0
    for (k, n), count in LAYER_KN.items():
        g = torch.Generator(device=dev).manual_seed(SEED + 7 * m + k + n)
        x = torch.randn((m, k), generator=g, device=dev,
                        dtype=torch.bfloat16).to(getattr(torch, act))
        trits = torch.randint(-1, 2, (n, k), generator=g, device=dev,
                              dtype=torch.int8)
        keys = TernaryWeight.from_ternary(trits).keys()
        wd = trits.to(torch.bfloat16).T
        xb = x.to(torch.bfloat16)
        t = cold_times_ms(lambda: fn(x, keys, 3), reps, flush)
        tl = cold_times_ms(lambda: torch.matmul(xb, wd), reps, flush)
        us, lib_us = sum(t) / len(t) * 1e3, sum(tl) / len(tl) * 1e3
        shapes[f"{k}x{n}"] = {"us": us, "library_us": lib_us}
        total += us * count / 1e3
        library += lib_us * count / 1e3
    return {"kernel": name, "M": m, "act": act, "layer_ms": total,
            "library_layer_ms": library, "shapes": shapes}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--m", type=int, nargs="+", default=[4, 32])
    ap.add_argument("--act", nargs="+", default=["bfloat16"],
                    choices=["bfloat16", "float32", "int8"])
    ap.add_argument("--kernels", nargs="+", default=["lut_gather", "lut_onehot"],
                    choices=["lut_gather", "lut_onehot"])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--tag", default="", help="a label copied into each line")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("lut_times: needs a CUDA card")
    from repro_torch.kernels.dispatch import FLUSH_BYTES

    print(json.dumps({"gpu": _smi("name,power.limit"),
                      "sm_clock_mhz": _smi("clocks.sm,clocks.max.sm"),
                      "tag": args.tag}), flush=True)
    flush = torch.zeros(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for act in args.act:
        for m in args.m:
            for name in args.kernels:
                row = time_layer(name, m, act, args.reps, flush)
                print(json.dumps({"tag": args.tag, **row}), flush=True)


if __name__ == "__main__":
    main()
