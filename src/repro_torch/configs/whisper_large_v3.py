"""whisper-large-v3 [audio]: enc-dec transformer; conv/mel frontend is a STUB
per the assignment (input_specs provides precomputed frame embeddings).
[arXiv:2212.04356; unverified]  Plain (non-gated) GELU FFN, sinusoidal
positions, MHA (kv == heads).  Assigned decode shapes apply to the decoder
self-attention cache; cross-attention covers the 1500 encoder frames."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="audio",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20, d_ff=5120,
    vocab_size=51_866, act_fn="gelu", ffn_gated=False,
    enc_layers=32, enc_seq=1500, frontend="audio_stub",
)
