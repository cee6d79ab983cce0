"""Model assembly: the decoder-only LM of the dense attention family and
the attention-free Mamba-2 family.

A ``Transformer`` holds the embedding table, one ``ModuleList`` of blocks
per segment of the config (the reference stacks each segment's per-layer
parameters on a leading axis and scans over them; here the segment is a
loop over its layers), the final norm, and an untied head where the
config has one.  ``forward`` runs the full sequence with no cache.

The port runs ATTN and SSM blocks.  A config with other block kinds,
MoE, an encoder or a modality frontend raises ``NotImplementedError``
(the config registry names the ROADMAP item of each arch); ``prefill``
and ``decode_step`` wait for the decode and cache path (ROADMAP Queue 1
item 11.3).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.index import resolve_device
from repro_torch.models.attention import Attention
from repro_torch.models.config import BlockKind, ModelConfig
from repro_torch.models.layers import (MLP, RMSNorm, embed, he_init_,
                                       param, unembed)
from repro_torch.models.ssm import SSM


def check_supported(cfg: ModelConfig) -> None:
    """Raise unless every part of ``cfg`` is ported."""
    ported = all(k in _BLOCKS and not seg.moe
                 for seg in cfg.segments for k in seg.kinds)
    if not ported or cfg.encoder_layers or cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: only ATTN and SSM blocks without MoE, encoder "
            f"or frontend are ported to repro_torch yet (ROADMAP Queue 1 "
            f"item 11)")


class Block(nn.Module):
    """ATTN block: x + attn(norm_mix(x)), then + mlp(norm_mlp(x))."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, dt, eps = cfg.d_model, cfg.pdtype, cfg.norm_eps
        self.norm_mix = RMSNorm(d, eps, dt, device)
        self.attn = Attention(cfg, device)
        self.norm_mlp = RMSNorm(d, eps, dt, device)
        self.mlp = MLP(d, cfg.d_ff, cfg.act, dt, device)

    def forward(self, x):
        x = x + self.attn(self.norm_mix(x))
        return x + self.mlp(self.norm_mlp(x))


class SSMBlock(nn.Module):
    """SSM block (mamba2): x + ssm(norm_mix(x)), no MLP sub-block."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.norm_mix = RMSNorm(cfg.d_model, cfg.norm_eps, cfg.pdtype, device)
        self.ssm = SSM(cfg, device)

    def forward(self, x):
        return x + self.ssm(self.norm_mix(x))


_BLOCKS = {BlockKind.ATTN: Block, BlockKind.SSM: SSMBlock}


class Transformer(nn.Module):
    """Parameters of a ported config on ``device`` (``cuda`` unless
    given; raises without a card); uninitialised until
    ``reset_parameters`` (``init_params``) or ``convert.py`` fills them."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        check_supported(cfg)
        device = resolve_device(device)
        self.cfg = cfg
        d, dt = cfg.d_model, cfg.pdtype
        self.embed_table = param(cfg.vocab_padded, d, dtype=dt,
                                 device=device)
        self.final_norm = RMSNorm(d, cfg.norm_eps, dt, device)
        # layer r * len(kinds) + j of a segment is copy r of its block j
        self.segments = nn.ModuleList(
            nn.ModuleList(_BLOCKS[kind](cfg, device)
                          for _ in range(seg.repeat) for kind in seg.kinds)
            for seg in cfg.segments)
        self.lm_head = (None if cfg.tie_embeddings else
                        param(d, cfg.vocab_padded, dtype=dt, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's distributions: embedding normal * 0.02, every
        projection normal / sqrt(fan_in), norm scales 1 (and the SSM's
        own, ``SSM.reset_parameters``)."""
        draw = torch.randn(self.embed_table.shape, generator=generator,
                           device=generator.device)
        self.embed_table.copy_(draw * 0.02)
        del draw
        if self.lm_head is not None:
            he_init_(self.lm_head, generator)
        for module in self.modules():
            if module is not self and hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)


def init_params(cfg: ModelConfig, *, generator: torch.Generator,
                device=None) -> Transformer:
    """A Transformer for ``cfg`` on ``device`` (``cuda`` unless given),
    drawn from ``generator``.  jax.random's streams are not reproduced:
    parity tests carry the reference's weights across with
    ``convert.py``."""
    model = Transformer(cfg, device)
    model.reset_parameters(generator)
    return model


def hidden_states(model: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    """Token embeddings (B, S) -> the last block's output (B, S, d), in
    the compute dtype, before the final norm."""
    x = embed(model.embed_table, tokens).to(model.cfg.cdtype)
    for blocks in model.segments:
        for block in blocks:
            x = block(x)
    return x


def _lm_head(model: Transformer, x):
    cfg = model.cfg
    head = model.embed_table.T if cfg.tie_embeddings else model.lm_head
    logits = unembed(head, x, cfg.logit_softcap)
    if cfg.vocab_padded != cfg.vocab:   # mask padded vocab rows
        pad = torch.arange(cfg.vocab_padded, device=x.device) >= cfg.vocab
        logits = logits.masked_fill(pad, -1e30)
    return logits


@torch.no_grad()
def forward(model: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    """Full-sequence forward -> logits (B, S, vocab_padded) f32.  (The
    reference also returns the MoE balance loss, which the ported
    families do not have.)"""
    x = model.final_norm(hidden_states(model, tokens))
    return _lm_head(model, x)
