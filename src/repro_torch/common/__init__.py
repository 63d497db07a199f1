from repro_torch.common.config import (  # noqa: F401
    ATTN, CROSS, GLOBAL, LOCAL, RGLRU, SSM, ModelConfig)
