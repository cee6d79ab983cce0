"""The model zoo, every family of the reference's: the dense attention
family (config, layers, attention, transformer), the Mixture-of-Experts
family (``moe``; MLA in ``attention``), the Mamba-2 family (``ssm``),
the RG-LRU hybrid with sliding-window attention (``rglru``) and the
encoder-decoder and VLM stubs (``encode``; ``enc_frames`` and
``frontend_emb``); all train (``loss_fn``) and serve through a cache
(``init_cache``, ``prefill``, ``decode_step``)."""
from repro_torch.models.config import (BlockKind, MLAConfig, ModelConfig,
                                       MoEConfig, RGLRUConfig, SSMConfig,
                                       Segment, count_params, dense_stack)
from repro_torch.models.transformer import (Transformer, check_trainable,
                                            decode_step, encode, forward,
                                            hidden_states, init_cache,
                                            init_params, load_param_tree,
                                            loss_fn, param_tree, prefill,
                                            value_and_grad)

__all__ = [
    "BlockKind", "MLAConfig", "ModelConfig", "MoEConfig", "RGLRUConfig",
    "SSMConfig", "Segment", "count_params", "dense_stack", "Transformer",
    "forward", "hidden_states", "init_params", "loss_fn", "check_trainable",
    "param_tree", "load_param_tree", "value_and_grad", "init_cache",
    "prefill", "decode_step", "encode",
]
