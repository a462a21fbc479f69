"""zamba2-2.7b [hybrid]: Mamba2 backbone + shared attention block.
[arXiv:2411.15242; hf]  Shared transformer block applied every 6th Mamba2
block with reused parameters (9 invocations over 54 layers)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=10_240,
    vocab_size=32_000, act_fn="silu",
    block_pattern="zamba2", ssm_state=64, ssm_expand=2, ssm_head_dim=64,
    attn_every=6,
)
