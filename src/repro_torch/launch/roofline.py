"""Roofline terms of a step on the H100 (the port's counterpart of the
reference's ``launch/roofline.py``).

Three terms per (arch × shape), in seconds:

    compute    = flops            / (chips × PEAK_FLOPS_BF16)
    memory     = bytes            / (chips × HBM_BW)
    collective = collective bytes / (chips × ICI_BW)

The counts come from :mod:`repro_torch.launch.op_cost`, run over the step
itself (:func:`from_trace`), where the reference reads XLA's compiled
artifact.  The peaks are one H100 SXM's (NVIDIA's data sheet, at its 700 W
limit), not the TPU's.  The interconnect keeps the reference's name,
``ICI_BW``: NVLink's rate a direction.  A trace runs one card's program,
so the collective term is 0 (the sharded ranks' gathers are counted by
``parallel.collectives``, not traced here).
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.launch import op_cost

#: H100 SXM: bf16 dense tensor-core FLOP/s
PEAK_FLOPS_BF16 = 989e12
#: H100 SXM: HBM3 bytes/s
HBM_BW = 3.35e12
#: H100 SXM: NVLink 4 bytes/s a direction (the reference's ICI term)
ICI_BW = 450e9
#: H100 SXM: f32 FLOP/s on the CUDA cores, int8 dense tensor-core OP/s
#: (the per-kernel bounds' other datapaths)
PEAK_FLOPS_F32 = 67e12
PEAK_OPS_INT8 = 1979e12


@dataclass
class Roofline:
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / PEAK_FLOPS_BF16

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes_per_device / ICI_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline step time = max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def as_dict(self) -> dict:
        return {
            "chips": self.chips,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "step_time_s": self.step_time_s,
        }


def model_flops(cfg, shape, kind: str) -> float:
    """MODEL_FLOPS = 6·N·D (train) / 2·N·D (fwd-only), N = active params."""
    n = cfg.active_param_count()
    if kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch


def from_trace(fn, *args, chips: int = 1, **kwargs) -> tuple[Roofline, dict]:
    """Run ``fn(*args, **kwargs)`` once under an
    :class:`~repro_torch.launch.op_cost.OpCounter` and return its roofline
    terms and the detail: the collective bytes by kind and their
    ``total``, ``torch.utils.flop_counter``'s raw total over the same run
    (``raw_flop_counter_flops``: it sees no hand kernel, and on the CPU
    it counts a plain version's products where the counter counts the
    ternary matmul), and the counter's ``bytes_materialized``, the bytes
    read, written and returned, ops counted and ternary matmuls.  The
    counts are one device's (``chips`` scales nothing until sharding)."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = op_cost.OpCounter()
    with FlopCounterMode(display=False) as raw:
        with counter:
            out = fn(*args, **kwargs)
    counter.returned(out)
    h = counter.result()
    detail = dict(h["collectives"])
    detail["total"] = h["collective_bytes"]
    detail["raw_flop_counter_flops"] = float(raw.get_total_flops())
    for key in ("flops", "bytes", "bytes_materialized", "bytes_read",
                "bytes_written", "bytes_returned", "ops", "flops_by_op",
                "ternary_matmuls"):
        detail[key] = h[key]
    rl = Roofline(chips=chips, flops_per_device=h["flops"],
                  bytes_per_device=h["bytes"],
                  collective_bytes_per_device=h["collective_bytes"])
    return rl, detail
