"""musicgen-medium — decoder-only transformer over EnCodec audio tokens
[arXiv:2306.05284].

48L d_model=1536 24H (kv=24 => MHA) d_ff=6144 vocab=2048 (EnCodec codebook),
a gelu MLP and an untied head.  Its blocks are self-attention only: the
stack has no cross-attention layer.  The EnCodec frontend is a stub in the
reference: ``forward`` also takes precomputed frame embeddings (B, S,
d_model) fused over the 4 codebooks.  Sinusoidal positions in the original
are replaced with RoPE, as in the reference.
"""
from repro_torch.common.config import ATTN, GLOBAL, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium",
        family="audio",
        num_layers=48,
        d_model=1536,
        num_heads=24,
        num_kv_heads=24,
        head_dim=64,
        d_ff=6144,
        vocab_size=2048,
        num_codebooks=4,
        mlp_kind="gelu",
        block_pattern=(ATTN,),
        attn_pattern=(GLOBAL,),
        rope_theta=10_000.0,
        tie_embeddings=False,
        max_seq_len=32_768,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=64, max_seq_len=128,
    )
