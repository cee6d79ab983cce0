"""granite-moe-1b-a400m [moe] -- 32 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf].

24L d_model=1024 16H (GQA kv=8) d_ff=512 vocab=49155, MoE 32e top-8.
"""
from repro_torch.models.config import ModelConfig, MoEConfig, dense_stack


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m",
        d_model=1024, n_heads=16, n_kv_heads=8, d_ff=512,
        vocab=49155, act="silu", tie_embeddings=True,
        segments=dense_stack(24, moe=True),
        moe=MoEConfig(n_experts=32, top_k=8, d_ff_expert=512),
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m-reduced",
        d_model=128, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab=512, act="silu", tie_embeddings=True,
        segments=dense_stack(2, moe=True),
        # capacity 8x in the reduced config => no token drops, so the
        # prefill/decode cache-exactness test can compare bitwise paths
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=128,
                      capacity_factor=8.0),
        param_dtype="float32", compute_dtype="float32",
    )
