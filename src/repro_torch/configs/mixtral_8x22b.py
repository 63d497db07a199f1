"""mixtral-8x22b — 8 experts top-2 MoE + sliding-window attention
[arXiv:2401.04088].

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768; SWA window 4096 on
every layer (bounds the KV cache => runs long_500k).
"""
from repro_torch.common.config import ATTN, LOCAL, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b",
        family="moe",
        num_layers=56,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab_size=32768,
        num_experts=8,
        num_experts_per_tok=2,
        block_pattern=(ATTN,),
        attn_pattern=(LOCAL,),
        sliding_window=4096,
        rope_theta=1_000_000.0,
        tie_embeddings=False,
        max_seq_len=524_288,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, num_experts=4, num_experts_per_tok=2,
        sliding_window=16, max_seq_len=128,
    )
