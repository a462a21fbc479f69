"""The port's core of the paper's contribution: ternary quantization, the
offline dense encoding, the two-phase LUT algorithm, the hardware generator
(netlist + functional simulator), the §IV analytical cost model, and the DSE
engine.  None of these imports ``kernels.dispatch`` (which imports the cost
model), so importing the package makes no cycle."""

from repro_torch.core import (  # noqa: F401
    cost_model,
    dse,
    encoding,
    lut_algorithm,
    netlist,
    quantization,
)
from repro_torch.core.generator import LUTCoreConfig, LUTCoreDesign, generate  # noqa: F401
