"""yi-34b [dense]: llama-arch GQA.  [arXiv:2403.04652; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b", family="dense",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=20_480,
    vocab_size=64_000, act_fn="silu", rope_theta=5_000_000.0,
    optimizer="adafactor",
)
