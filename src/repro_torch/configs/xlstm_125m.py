"""xlstm-125m [ssm]: alternating mLSTM/sLSTM blocks, d_ff=0 (projection-only
blocks).  [arXiv:2405.04517; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab_size=50_304, block_pattern="xlstm",
)
