"""codeqwen1.5-7b [dense] -- qwen1.5 arch [hf:Qwen/CodeQwen1.5-7B; hf].

32L d_model=4096 32H (GQA kv=32 -> effectively MHA) d_ff=13440 vocab=92416.
"""
from repro_torch.models.config import ModelConfig, dense_stack


def config() -> ModelConfig:
    return ModelConfig(
        name="codeqwen1.5-7b",
        d_model=4096, n_heads=32, n_kv_heads=32, d_ff=13440,
        vocab=92416, act="silu", rope_theta=1_000_000.0,
        segments=dense_stack(32),
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="codeqwen1.5-7b-reduced",
        d_model=128, n_heads=4, n_kv_heads=4, d_ff=384,
        vocab=512, act="silu", rope_theta=1_000_000.0,
        segments=dense_stack(2),
        param_dtype="float32", compute_dtype="float32",
    )
