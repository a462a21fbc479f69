"""Assigned input shapes and per-(arch × shape) dry-run cells (the port's
own copy of the reference's).

Four shapes per LM architecture:
  train_4k     seq 4,096   global_batch 256   → the QAT ``train_step``
  prefill_32k  seq 32,768  global_batch 32    → ``decode.prefill``
  decode_32k   seq 32,768  global_batch 128   → ``decode.decode_step`` (1 new
                                                 token, KV cache of seq_len)
  long_500k    seq 524,288 global_batch 1     → ``decode.decode_step``;
                                                 sub-quadratic archs only
                                                 (SSM/hybrid)
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": Shape("train_4k", 4_096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32_768, 128, "decode"),
    "long_500k": Shape("long_500k", 524_288, 1, "decode"),
}

#: archs with O(1)-state (or windowed) decode that run the 500k cell
SUBQUADRATIC = {"zamba2-2.7b", "xlstm-125m"}


def cells_for(arch_name: str) -> list[str]:
    """Dry-run cells for an arch (long_500k only for the sub-quadratic
    archs)."""
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if arch_name in SUBQUADRATIC:
        cells.append("long_500k")
    return cells
