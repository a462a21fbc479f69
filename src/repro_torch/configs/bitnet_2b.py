"""bitnet-b1.58-2b — the paper's native model family (BitNet b1.58 2B4T
class): W1.58A8 with INT8 activation fake-quant enabled, the operating point
the LUT accelerator is built for (Table I)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="bitnet-b1.58-2b", family="dense",
    n_layers=30, d_model=2560, n_heads=20, n_kv_heads=5, d_ff=6912,
    vocab_size=128_256, act_fn="silu",
    quantize_acts=True,
)
