"""The model zoo of the retrieval service's embedder, as far as ported:
the dense attention family (config, layers, attention, transformer)."""
from repro_torch.models.config import (BlockKind, MLAConfig, ModelConfig,
                                       MoEConfig, RGLRUConfig, SSMConfig,
                                       Segment, dense_stack)
from repro_torch.models.transformer import (Transformer, forward,
                                            hidden_states, init_params)

__all__ = [
    "BlockKind", "MLAConfig", "ModelConfig", "MoEConfig", "RGLRUConfig",
    "SSMConfig", "Segment", "dense_stack", "Transformer", "forward",
    "hidden_states", "init_params",
]
