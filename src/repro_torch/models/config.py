"""Model configuration schema shared by all assigned architectures (the
port's own copy of the reference schema, field for field)."""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Literal

Family = Literal["dense", "moe", "hybrid", "ssm", "audio", "vlm"]


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 → d_model // n_heads

    # attention flavor
    qkv_bias: bool = False
    qk_norm: bool = False
    window: int = 0            # sliding-window size for decode/long ctx (0 = full)
    rope_theta: float = 10_000.0

    # block flavor
    act_fn: str = "silu"       # "silu" (SwiGLU) | "gelu" (GeGLU)
    ffn_gated: bool = True     # False → plain 2-layer MLP (whisper)
    rmsnorm_offset: bool = False   # gemma: weight stored as (1 + w)
    embed_scale: bool = False      # gemma: scale embeddings by sqrt(d_model)
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    moe_shared_expert: bool = False
    moe_every: int = 1         # MoE on every k-th layer (others dense)
    dense_ff: int = 0          # d_ff of interleaved dense layers (0 → d_ff)
    capacity_factor: float = 1.25

    # SSM / hybrid / recurrent
    block_pattern: str = "attn"    # attn | mamba2 | zamba2 | xlstm
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    attn_every: int = 0            # zamba2: shared attn block every k mamba blocks

    # encoder-decoder (whisper) / modality frontends
    enc_layers: int = 0
    enc_seq: int = 0               # encoder positions (whisper: 1500 frames)
    frontend: str = "none"         # none | audio_stub | vit_stub
    vision_tokens: int = 0         # vlm: prefix positions fed from the stub

    # quantization (the paper's technique)
    quant: str = "qat"             # "fp" | "qat" (training); serving packs ternary
    quantize_acts: bool = False    # optional INT8 activation fake-quant in QAT
    mu: int = 3                    # LUT group size for the lut serving path
    act_dtype: str = "none"        # serving activation dtype for the packed
                                   # ternary projections: "none" keeps the
                                   # compute dtype (bf16 dequant paths);
                                   # "int8" quantizes per token (absmax) in
                                   # front of every packed matmul so dispatch
                                   # routes the W1.58A8 kernels
                                   # (w2a8/grouped_w2a8/tl2)
    matmul_policy: str | None = None   # ternary-matmul dispatch: "auto" |
                                       # "prior" | "fixed:<kernel>"; None
                                       # means "auto" (repro_torch.kernels.dispatch)

    # numerics / training
    dtype: str = "bfloat16"
    remat: bool = True
    loss_chunk: int = 512          # vocab-projection chunking for CE loss
    optimizer: str = "adamw"       # "adamw" | "adafactor" (for >=30B archs)

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        assert self.n_heads % max(self.n_kv_heads, 1) == 0

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 for clean TP sharding of the
        embedding/LM head (standard practice, e.g. MaxText).  Logits beyond
        ``vocab_size`` are masked to -inf in the loss and at decode."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), for roofline
        MODEL_FLOPS and reporting."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.block_pattern in ("attn",):
            attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            if self.act_fn in ("silu", "gelu"):
                ffn = 3 * d * f
            else:
                ffn = 2 * d * f
            if self.n_experts:
                moe_layers = self.n_layers // self.moe_every
                dense_layers = self.n_layers - moe_layers
                dff = self.dense_ff or f
                ffn_dense = 3 * d * dff
                blocks = self.n_layers * attn + dense_layers * ffn_dense \
                    + moe_layers * (self.n_experts * ffn + d * self.n_experts
                                    + (ffn if self.moe_shared_expert else 0))
            else:
                blocks = self.n_layers * (attn + ffn)
        elif self.block_pattern == "zamba2":
            d_in = self.ssm_expand * d
            mamba = d * 2 * d_in + d_in * d + d_in * (2 * self.ssm_state)
            attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d + 3 * d * f
            blocks = self.n_layers * mamba + attn  # shared attn counted once
        elif self.block_pattern == "mamba2":
            d_in = self.ssm_expand * d
            blocks = self.n_layers * (d * 2 * d_in + d_in * d + d_in * 2 * self.ssm_state)
        elif self.block_pattern == "xlstm":
            d_in = 2 * d
            mlstm = d * 2 * d_in + d_in * d + 3 * d_in * d_in // 4
            slstm = 4 * d * d + 4 * (d // self.n_heads) * d
            blocks = (self.n_layers // 2) * (mlstm + slstm)
        else:
            blocks = 0
        if self.is_encdec:
            attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            ffn = 2 * d * f
            blocks = self.enc_layers * (attn + ffn) + self.n_layers * (2 * attn + ffn)
        return emb + blocks

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only routed experts)."""
        if not self.n_experts:
            return self.param_count()
        full = self.param_count()
        f, d = self.d_ff, self.d_model
        ffn = 3 * d * f
        moe_layers = self.n_layers // self.moe_every
        inactive = moe_layers * (self.n_experts - self.experts_per_token) * ffn
        return full - inactive

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Shrink a config to smoke-test scale, preserving the family's structure
    (GQA ratio, MoE routing, SSM blocks, enc-dec split, shared-attn cadence)."""
    ratio = max(cfg.n_heads // max(cfg.n_kv_heads, 1), 1)
    kw = dict(
        n_layers=min(cfg.n_layers, 4 if cfg.attn_every == 0 else 2 * cfg.attn_every),
        d_model=128,
        n_heads=4,
        n_kv_heads=max(4 // ratio, 1),
        head_dim=32,
        d_ff=0 if cfg.d_ff == 0 else 256,
        vocab_size=512,
        loss_chunk=64,
    )
    if cfg.n_experts:
        kw.update(n_experts=min(cfg.n_experts, 8),
                  experts_per_token=cfg.experts_per_token)
    if cfg.enc_layers:
        kw.update(enc_layers=2, enc_seq=16)
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_head_dim=16)
    if cfg.vision_tokens:
        kw.update(vision_tokens=8)
    kw.update(overrides)
    return cfg.with_(**kw)
