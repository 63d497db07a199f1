"""mamba2-780m — SSD (state-space duality), attention-free [arXiv:2405.21060].

48L d_model=1536 d_ff=0 vocab=50280 ssm_state=128; expand=2 -> d_inner=3072,
head_dim=64 -> 48 SSD heads.  No MLP (d_ff=0): the Mamba2 block IS the layer.
"""
from repro_torch.common.config import SSM, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m",
        family="ssm",
        num_layers=48,
        d_model=1536,
        num_heads=24,            # unused (attn-free); kept for config uniformity
        num_kv_heads=24,
        d_ff=0,
        vocab_size=50280,
        block_pattern=(SSM,),
        ssm_state=128,
        ssm_expand=2,
        ssm_head_dim=64,
        ssm_chunk=128,
        conv_width=4,
        tie_embeddings=True,
        max_seq_len=524_288,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=4,
        vocab_size=256, ssm_state=16, ssm_head_dim=16, ssm_chunk=16,
        max_seq_len=128,
    )
