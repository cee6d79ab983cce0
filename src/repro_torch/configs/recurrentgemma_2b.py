"""recurrentgemma-2b [hybrid] -- RG-LRU + local attention, 1:2
[arXiv:2402.19427; hf].

26L d_model=2560 10H (MQA kv=1) head_dim=256 d_ff=7680 (GeGLU)
vocab=256000; pattern: (recurrent, recurrent, local-attn) x 8 + 2
recurrent, window=2048.
"""
from repro_torch.models.config import (BlockKind, ModelConfig, RGLRUConfig,
                                 Segment)


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b",
        d_model=2560, n_heads=10, n_kv_heads=1, head_dim=256,
        d_ff=7680, vocab=256000, act="gelu", tie_embeddings=True,
        window=2048, logit_softcap=30.0,
        segments=(
            Segment(kinds=(BlockKind.RGLRU, BlockKind.RGLRU,
                           BlockKind.LOCAL_ATTN), repeat=8),
            Segment(kinds=(BlockKind.RGLRU, BlockKind.RGLRU), repeat=1),
        ),
        rglru=RGLRUConfig(lru_width=2560, window=2048),
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b-reduced",
        d_model=128, n_heads=2, n_kv_heads=1, head_dim=64,
        d_ff=256, vocab=512, act="gelu", tie_embeddings=True,
        window=64, logit_softcap=30.0,
        segments=(
            Segment(kinds=(BlockKind.RGLRU, BlockKind.RGLRU,
                           BlockKind.LOCAL_ATTN), repeat=2),
        ),
        rglru=RGLRUConfig(lru_width=128, window=64),
        param_dtype="float32", compute_dtype="float32",
    )
