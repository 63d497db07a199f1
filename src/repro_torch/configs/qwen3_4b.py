"""qwen3-4b — qk_norm + GQA [hf:Qwen/Qwen3-8B family].

36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936, head_dim=128.
"""
from repro_torch.common.config import ATTN, GLOBAL, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-4b",
        family="dense",
        num_layers=36,
        d_model=2560,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=9728,
        vocab_size=151936,
        use_qk_norm=True,
        block_pattern=(ATTN,),
        attn_pattern=(GLOBAL,),
        rope_theta=1_000_000.0,
        tie_embeddings=True,
        max_seq_len=32_768,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, max_seq_len=128,
    )
