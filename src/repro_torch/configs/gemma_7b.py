"""gemma-7b [dense]: GeGLU, head_dim 256, RMSNorm(1+w), scaled embeddings,
tied LM head.  [arXiv:2403.08295; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b", family="dense",
    n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16, d_ff=24_576,
    vocab_size=256_000, head_dim=256, act_fn="gelu",
    rmsnorm_offset=True, embed_scale=True, tie_embeddings=True,
)
