"""deepseek-v2-lite-16b [moe] -- MLA kv_lora=512, shared+routed MoE top-6
[arXiv:2405.04434; hf].

27L d_model=2048 16H d_ff(expert)=1408 vocab=102400, MoE 64e top-6 with
2 shared experts; layer 0 is a dense MLP (d_ff=10944, per the HF config),
layers 1..26 are MoE -- modelled as two segments.
"""
from repro_torch.models.config import (BlockKind, MLAConfig, ModelConfig,
                                       MoEConfig, Segment)


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b",
        d_model=2048, n_heads=16, n_kv_heads=16, d_ff=10944,
        vocab=102400, act="silu",
        segments=(
            Segment(kinds=(BlockKind.MLA,), repeat=1, moe=False),
            Segment(kinds=(BlockKind.MLA,), repeat=26, moe=True),
        ),
        mla=MLAConfig(kv_lora=512, rope_dim=64, nope_dim=128, v_dim=128),
        moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408,
                      n_shared=2, d_ff_shared=2816),
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b-reduced",
        d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
        vocab=512, act="silu",
        segments=(
            Segment(kinds=(BlockKind.MLA,), repeat=1, moe=False),
            Segment(kinds=(BlockKind.MLA,), repeat=2, moe=True),
        ),
        mla=MLAConfig(kv_lora=64, rope_dim=16, nope_dim=32, v_dim=32),
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=64,
                      n_shared=1, d_ff_shared=128, capacity_factor=8.0),
        param_dtype="float32", compute_dtype="float32",
    )
