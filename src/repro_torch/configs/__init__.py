"""Architecture configs of the zoo (``--arch <id>``), all ten ported.

The registry keeps the reference's ids and aliases: the dense attention
archs (gemma-7b, codeqwen1.5-7b, phi3-mini-3.8b, mistral-nemo-12b), the
MoE archs (granite-moe-1b-a400m; deepseek-v2-lite-16b, MLA and shared
experts), the attention-free mamba2-130m, the RG-LRU hybrid with local
attention (recurrentgemma-2b), the encoder-decoder with an audio stub
(whisper-medium) and the VLM with a vision stub (pixtral-12b).
"""
from __future__ import annotations

import importlib

ARCHS = [
    "codeqwen1_5_7b",
    "gemma_7b",
    "phi3_mini_3_8b",
    "mistral_nemo_12b",
    "pixtral_12b",
    "granite_moe_1b_a400m",
    "deepseek_v2_lite_16b",
    "whisper_medium",
    "mamba2_130m",
    "recurrentgemma_2b",
]

_ALIASES = {a.replace("_", "-"): a for a in ARCHS}
_ALIASES.update({
    "codeqwen1.5-7b": "codeqwen1_5_7b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
})


def list_archs():
    """The zoo's arch ids, in the reference's registry order."""
    return list(ARCHS)


def get_config(name: str, reduced: bool = False):
    """Load an architecture config by id (dash or underscore form).

    reduced=True returns the small same-family config of the tests.
    """
    mod_name = _ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    if mod_name not in ARCHS:
        raise ValueError(f"unknown arch {name!r}; known: {ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.reduced_config() if reduced else mod.config()
