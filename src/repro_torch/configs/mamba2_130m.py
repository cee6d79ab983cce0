"""mamba2-130m [ssm] -- SSD (state-space duality) [arXiv:2405.21060;
the public state-spaces/mamba2-130m config has the same widths].

24L d_model=768 (attention-free) vocab=50280, ssm_state=128,
expand=2 (d_inner=1536), head_dim=64 -> 24 SSD heads, 1 B/C group.
"""
from repro_torch.models.config import (BlockKind, ModelConfig, SSMConfig,
                                       dense_stack)


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m",
        d_model=768, n_heads=24, n_kv_heads=24, d_ff=0,
        vocab=50280, act="silu", tie_embeddings=True,
        segments=dense_stack(24, kind=BlockKind.SSM),
        ssm=SSMConfig(d_state=128, head_dim=64, expand=2, n_groups=1),
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m-reduced",
        d_model=128, n_heads=4, n_kv_heads=4, d_ff=0,
        vocab=512, act="silu", tie_embeddings=True,
        segments=dense_stack(2, kind=BlockKind.SSM),
        ssm=SSMConfig(d_state=16, head_dim=32, expand=2, n_groups=1),
        param_dtype="float32", compute_dtype="float32",
    )
