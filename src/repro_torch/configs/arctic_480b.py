"""arctic-480b — 128-expert top-2 MoE with a parallel dense-residual FFN
[hf:Snowflake/snowflake-arctic-base].

35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000; every layer runs a
dense FFN residual in parallel with the 128e/top-2 MoE (dense-MoE hybrid).
"""
from repro_torch.common.config import ATTN, GLOBAL, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b",
        family="moe",
        num_layers=35,
        d_model=7168,
        num_heads=56,
        num_kv_heads=8,
        head_dim=128,
        d_ff=4864,
        vocab_size=32000,
        num_experts=128,
        num_experts_per_tok=2,
        moe_dense_ff=4864,
        block_pattern=(ATTN,),
        attn_pattern=(GLOBAL,),
        rope_theta=10_000.0,
        tie_embeddings=False,
        max_seq_len=32_768,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, num_experts=8, num_experts_per_tok=2,
        moe_dense_ff=128, max_seq_len=128,
    )
