"""gemma-7b [dense] -- GeGLU, head_dim=256 [arXiv:2403.08295; hf].

28L d_model=3072 16H (GQA kv=16) d_ff=24576 vocab=256000.
"""
from repro_torch.models.config import ModelConfig, dense_stack


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma-7b",
        d_model=3072, n_heads=16, n_kv_heads=16, head_dim=256,
        d_ff=24576, vocab=256000, act="gelu",
        tie_embeddings=True, logit_softcap=30.0,
        segments=dense_stack(28),
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="gemma-7b-reduced",
        d_model=96, n_heads=2, n_kv_heads=2, head_dim=48,
        d_ff=256, vocab=512, act="gelu",
        tie_embeddings=True, logit_softcap=30.0,
        segments=dense_stack(2),
        param_dtype="float32", compute_dtype="float32",
    )
