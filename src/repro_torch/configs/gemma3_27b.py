"""gemma3-27b — 5:1 local:global attention, 128k context
[hf:google/gemma-3 family].

62L d_model=5376 32H (GQA kv=16) d_ff=21504 vocab=262144; head_dim=128;
qk-norm; sliding window 1024 on local layers; rope base 1M global / 10k
local.  62 = 10 full (5L+1G) periods + 2 tail local layers.
"""
from repro_torch.common.config import ATTN, GLOBAL, LOCAL, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-27b",
        family="dense",
        num_layers=62,
        d_model=5376,
        num_heads=32,
        num_kv_heads=16,
        head_dim=128,
        d_ff=21504,
        vocab_size=262144,
        use_qk_norm=True,
        block_pattern=(ATTN,),
        attn_pattern=(LOCAL, LOCAL, LOCAL, LOCAL, LOCAL, GLOBAL),
        sliding_window=1024,
        rope_theta=1_000_000.0,
        local_rope_theta=10_000.0,
        mlp_kind="geglu",
        tie_embeddings=True,
        max_seq_len=524_288,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=7,      # 1 full (5L+1G) period + 1 tail layer
        d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, sliding_window=16, max_seq_len=128,
    )
