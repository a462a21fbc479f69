"""llama4-maverick-400b-a17b [moe]: 128 experts top-1 + shared expert, MoE on
every other layer with 2x dense FFN between (matches the release's ~400B
total / ~17B active).  [hf:meta-llama/Llama-4; unverified]  Early-fusion VLM
aspect reduced to the token backbone per the assignment's LM shapes."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192,
    vocab_size=202_048, act_fn="silu",
    n_experts=128, experts_per_token=1, moe_shared_expert=True,
    moe_every=2, dense_ff=16_384,
    optimizer="adafactor", capacity_factor=1.25,
)
