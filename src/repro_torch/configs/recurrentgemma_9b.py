"""recurrentgemma-9b — Griffin: RG-LRU recurrent blocks + local attention,
2:1 recurrent:attention [arXiv:2402.19427].

38L d_model=4096 16H (GQA kv=1 => MQA) d_ff=12288 vocab=256000; head_dim=256;
local attention window 2048; pattern (rglru, rglru, attn) -> 12 periods + 2
tail rglru layers.  Bounded state => runs long_500k.
"""
from repro_torch.common.config import ATTN, LOCAL, RGLRU, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        num_layers=38,
        d_model=4096,
        num_heads=16,
        num_kv_heads=1,
        head_dim=256,
        d_ff=12288,
        vocab_size=256000,
        block_pattern=(RGLRU, RGLRU, ATTN),
        attn_pattern=(LOCAL,),
        sliding_window=2048,
        mlp_kind="geglu",
        rope_theta=10_000.0,
        rglru_c=8.0,
        conv_width=4,
        tie_embeddings=True,
        max_seq_len=524_288,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=4,      # one (rglru, rglru, attn) period + 1 tail rglru
        d_model=64, num_heads=4, num_kv_heads=1, head_dim=16,
        d_ff=128, vocab_size=256, sliding_window=16, max_seq_len=128,
    )
