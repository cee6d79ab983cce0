"""pixtral-12b [vlm] -- pixtral-ViT frontend + mistral-nemo backbone
[hf:mistralai/Pixtral-12B-2409; unverified].

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072. The vision
frontend is a STUB: the caller passes precomputed patch embeddings (B,
frontend_tokens, d_model) as ``frontend_emb``, prepended to the text.
"""
from repro_torch.models.config import ModelConfig, dense_stack


def config() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b",
        d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab=131072, act="silu", rope_theta=1_000_000.0,
        segments=dense_stack(40),
        frontend="vision", frontend_tokens=1024,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b-reduced",
        d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=384, vocab=512, act="silu",
        segments=dense_stack(2),
        frontend="vision", frontend_tokens=16,
        param_dtype="float32", compute_dtype="float32",
    )
