"""Model configuration of the architecture zoo (a copy of the reference's).

One ModelConfig describes any of the zoo's families through a block
pattern: layers are grouped into repeated *segments* of a unit of block
kinds.  The port runs every kind -- global and sliding-window attention,
MLA, the Mamba-2 SSD block and the RG-LRU block, with the gated or the
MoE MLP -- and the encoder-decoder and modality-frontend stubs.

``pdtype``/``cdtype`` are torch dtypes.  The port imports nothing of the
reference package.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import torch


class BlockKind(str, enum.Enum):
    ATTN = "attn"            # global attention + MLP
    LOCAL_ATTN = "local"     # sliding-window attention + MLP
    MLA = "mla"              # multi-head latent attention + MLP/MoE
    SSM = "ssm"              # Mamba-2 SSD block
    RGLRU = "rglru"          # RG-LRU recurrent block + MLP


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    d_ff_shared: int = 0
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora: int = 512
    rope_dim: int = 64
    nope_dim: int = 128
    v_dim: int = 128
    q_lora: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64     # P
    expand: int = 2
    n_groups: int = 1
    d_conv: int = 4


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    lru_width: int = 0         # 0 -> d_model
    window: int = 2048         # local attention window in hybrid pattern
    d_conv: int = 4


@dataclasses.dataclass(frozen=True)
class Segment:
    """``repeat`` copies of a unit of blocks."""
    kinds: tuple                 # tuple[BlockKind, ...] -- the unit pattern
    repeat: int
    moe: bool = False            # blocks in this segment use MoE MLP


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    segments: tuple              # tuple[Segment, ...]
    head_dim: Optional[int] = None   # default d_model // n_heads
    act: str = "silu"            # silu (SwiGLU) | gelu (GeGLU)
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    window: int = 4096           # sliding window for LOCAL_ATTN blocks
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    # encoder-decoder (whisper): encoder depth/frames; 0 = decoder-only
    encoder_layers: int = 0
    encoder_frames: int = 1500
    # modality frontend stub: extra embedded tokens prepended to the text
    frontend: str = "none"       # none | audio | vision
    frontend_tokens: int = 0     # e.g. image patches for the VLM stub
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    vocab_pad_to: int = 512      # pad vocab for clean sharding

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        p = self.vocab_pad_to
        return (self.vocab + p - 1) // p * p

    @property
    def n_layers(self) -> int:
        return sum(len(s.kinds) * s.repeat for s in self.segments)

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def is_attention_free(self) -> bool:
        return all(k in (BlockKind.SSM,)
                   for s in self.segments for k in s.kinds)

    def is_subquadratic(self) -> bool:
        """True if decode cost per token is O(1)-ish in context length
        (SSM / RG-LRU / local-window only)."""
        return all(k in (BlockKind.SSM, BlockKind.RGLRU, BlockKind.LOCAL_ATTN)
                   for s in self.segments for k in s.kinds)


def dense_stack(n_layers: int, kind: BlockKind = BlockKind.ATTN,
                moe: bool = False) -> tuple:
    return (Segment(kinds=(kind,), repeat=n_layers, moe=moe),)


def count_params(cfg: ModelConfig) -> int:
    """Parameter count of a config (used for 6ND model FLOPs and
    reports), counted from the port's modules built on the meta device:
    shapes only, nothing is allocated."""
    from repro_torch.models.transformer import Transformer  # no cycle
    model = Transformer(cfg, device="meta")
    return sum(p.numel() for p in model.parameters())
