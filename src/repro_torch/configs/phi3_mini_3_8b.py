"""phi3-mini-3.8b [dense] -- RoPE SwiGLU GQA [arXiv:2404.14219; unverified].

32L d_model=3072 32H (GQA kv=32) d_ff=8192 vocab=32064.
"""
from repro_torch.models.config import ModelConfig, dense_stack


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-3.8b",
        d_model=3072, n_heads=32, n_kv_heads=32, d_ff=8192,
        vocab=32064, act="silu",
        segments=dense_stack(32),
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-3.8b-reduced",
        d_model=128, n_heads=4, n_kv_heads=4, d_ff=320,
        vocab=512, act="silu",
        segments=dense_stack(2),
        param_dtype="float32", compute_dtype="float32",
    )
