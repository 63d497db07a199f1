"""minicpm-2b — llama-like dense, trained with the WSD schedule
[arXiv:2404.06395].  40L d_model=2304 36H (kv=36 => MHA) d_ff=5760
vocab=122753.  The WSD (warmup-stable-decay) schedule is this arch's
default train schedule in the JAX package (``repro.training.schedules``);
the port serves it and does not train yet.
"""
from repro_torch.common.config import ATTN, GLOBAL, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minicpm-2b",
        family="dense",
        num_layers=40,
        d_model=2304,
        num_heads=36,
        num_kv_heads=36,
        head_dim=64,
        d_ff=5760,
        vocab_size=122753,
        block_pattern=(ATTN,),
        attn_pattern=(GLOBAL,),
        rope_theta=10_000.0,
        tie_embeddings=True,
        max_seq_len=32_768,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=256, max_seq_len=128,
    )
