"""The model zoo of the retrieval service's embedder, as far as ported:
the dense attention family (config, layers, attention, transformer), the
Mixture-of-Experts family (``moe``; MLA in ``attention``) and the
Mamba-2 family; all train (``loss_fn``) and serve through a cache
(``init_cache``, ``prefill``, ``decode_step``)."""
from repro_torch.models.config import (BlockKind, MLAConfig, ModelConfig,
                                       MoEConfig, RGLRUConfig, SSMConfig,
                                       Segment, count_params, dense_stack)
from repro_torch.models.transformer import (Transformer, check_trainable,
                                            decode_step, forward,
                                            hidden_states, init_cache,
                                            init_params, load_param_tree,
                                            loss_fn, param_tree, prefill,
                                            value_and_grad)

__all__ = [
    "BlockKind", "MLAConfig", "ModelConfig", "MoEConfig", "RGLRUConfig",
    "SSMConfig", "Segment", "count_params", "dense_stack", "Transformer",
    "forward", "hidden_states", "init_params", "loss_fn", "check_trainable",
    "param_tree", "load_param_tree", "value_and_grad", "init_cache",
    "prefill", "decode_step",
]
