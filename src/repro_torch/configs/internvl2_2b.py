"""internvl2-2b [vlm]: InternViT frontend (stub) + InternLM2-1.8B GQA backbone.
[arXiv:2404.16821; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, d_ff=8192,
    vocab_size=92_553, act_fn="silu",
    frontend="vit_stub", vision_tokens=64,
)
