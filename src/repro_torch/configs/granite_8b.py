"""granite-8b — llama-arch code model [arXiv:2405.04324].

36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152.
"""
from repro_torch.common.config import ATTN, GLOBAL, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-8b",
        family="dense",
        num_layers=36,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=49152,
        block_pattern=(ATTN,),
        attn_pattern=(GLOBAL,),
        rope_theta=10_000_000.0,
        tie_embeddings=False,
        max_seq_len=32_768,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, max_seq_len=128,
    )
