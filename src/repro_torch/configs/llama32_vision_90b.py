"""llama-3.2-vision-90b — dense decoder with interleaved cross-attention
image layers [hf:meta-llama/Llama-3.2-11B-Vision family].

100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256; every 5th layer is
a cross-attention layer over stub patch embeddings (B, 1601, d_model): the
vision tower is a stub in the reference, and the caller passes ``enc`` to
``forward`` and ``prefill``.
"""
from repro_torch.common.config import ATTN, CROSS, GLOBAL, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b",
        family="vlm",
        num_layers=100,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=28672,
        vocab_size=128256,
        block_pattern=(ATTN, ATTN, ATTN, ATTN, CROSS),
        attn_pattern=(GLOBAL,),
        num_image_tokens=1601,
        rope_theta=500_000.0,
        tie_embeddings=False,
        max_seq_len=32_768,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=5,      # one full (4 self + 1 cross) period
        d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, num_image_tokens=8, max_seq_len=128,
    )
