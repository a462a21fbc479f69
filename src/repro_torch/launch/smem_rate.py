"""Shared memory's read rate on the card, for the ceiling of
``lut_gather``'s table reads (``csrc/lut_matmul.cu``'s note models them at
128 bytes a clock an SM, a warp's 64-bit read as two wavefronts).

Builds ``csrc/smem_probe.cu`` and runs it with one block of ``--threads``
threads per SM, each warp reading a gather-shaped table ``--iters`` times
(see the probe's note for the three patterns).  For each pattern, prints
one JSON line: the bytes a warp's reads request per SM clock (per block,
median, min and max over the blocks: a block's span is from its first
warp's start to its last warp's end, in ``clock64`` cycles), the SM clock
over the loop (cycles over ``globaltimer`` ns), and the card-wide rate
these give.  First, the card's name, power limit and SM clocks from
nvidia-smi.

Usage (on the card):
  python -m repro_torch.launch.smem_rate [--threads 1024] [--iters 2000]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

PATTERNS = {0: "gather: at most 14 distinct 8-byte entries a read",
            1: "broadcast: one entry for all 32 lanes",
            2: "distinct: 32 consecutive 8-byte entries a read"}
#: 64-bit reads a lane makes each pass: 16 groups x 8 row pairs
READS_PER_PASS = 16 * 8


def _smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def _entry():
    from repro_torch.kernels._build import load

    fn = load("smem_probe").smem_probe
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4
    return fn


def measure(pattern: int, blocks: int, threads: int, iters: int) -> dict:
    warps = threads // 32
    sink = torch.empty(blocks * threads, dtype=torch.float32, device="cuda")
    cycles = torch.empty(2 * blocks * warps, dtype=torch.int64, device="cuda")
    ns = torch.empty_like(cycles)
    fn = _entry()
    for _ in range(2):                      # the first run warms up
        rc = fn(pattern, blocks, threads, iters, sink.data_ptr(),
                cycles.data_ptr(), ns.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"smem_probe failed: CUDA error {rc}")
    torch.cuda.synchronize()
    c = cycles.view(blocks, warps, 2).cpu().double()
    t = ns.view(blocks, warps, 2).cpu().double()
    span_c = c[:, :, 1].max(1).values - c[:, :, 0].min(1).values
    span_t = t[:, :, 1].max(1).values - t[:, :, 0].min(1).values
    requested = warps * iters * READS_PER_PASS * 32 * 8   # bytes a block
    per_clock = requested / span_c
    clock_mhz = float((span_c / span_t).median()) * 1e3
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return {"pattern": pattern, "what": PATTERNS[pattern],
            "bytes_per_clock_per_sm": {
                "median": float(per_clock.median()),
                "min": float(per_clock.min()), "max": float(per_clock.max())},
            "sm_clock_mhz_in_loop": clock_mhz,
            "card_bytes_per_s": float(per_clock.median()) * sms * clock_mhz * 1e6,
            "blocks": blocks, "threads": threads, "iters": iters}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--threads", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=2000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("smem_rate: needs a CUDA card")
    blocks = torch.cuda.get_device_properties(0).multi_processor_count
    print(json.dumps({"gpu": _smi("name,power.limit"),
                      "sm_clock_mhz": _smi("clocks.sm,clocks.max.sm")}),
          flush=True)
    for pattern in PATTERNS:
        print(json.dumps(measure(pattern, blocks, args.threads, args.iters)),
              flush=True)
    print(json.dumps({"sm_clock_mhz_after": _smi("clocks.sm,clocks.max.sm")}),
          flush=True)


if __name__ == "__main__":
    main()
