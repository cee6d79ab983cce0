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

Training: ``loss_fn`` is the reference's, through a differentiable
forward with the reference's per-block rematerialisation (its
``jax.checkpoint`` of each scanned unit, here ``torch.utils.checkpoint``,
non-reentrant).  Every ported config trains: the dense family through
the flash kernel and its gradient kernel, the SSM family through the SSD
scan and its gradient kernel.  ``param_tree`` lays the
parameters (or gradients) out as the reference's pytree, each segment's
leaves stacked over its repeats, so the optimizer state and the training
checkpoints have the reference's leaf paths; ``load_param_tree`` is the
inverse, and ``value_and_grad`` gives the loss and that tree of
gradients.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.index import resolve_device
from repro_torch.models.attention import Attention
from repro_torch.models.config import BlockKind, ModelConfig
from repro_torch.models.layers import (MLP, RMSNorm, cross_entropy, embed,
                                       he_init_, param, unembed)
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


def check_trainable(cfg: ModelConfig) -> None:
    """Raise unless ``cfg`` trains on the port: every config that
    ``check_supported`` admits does (ATTN blocks through the flash
    gradient kernel, SSM blocks through the SSD one)."""
    check_supported(cfg)


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

    @torch.no_grad()
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


def _blocks(model: Transformer, tokens: torch.Tensor, remat: bool):
    x = embed(model.embed_table, tokens).to(model.cfg.cdtype)
    for blocks in model.segments:
        for block in blocks:
            x = (checkpoint(block, x, use_reentrant=False) if remat
                 else block(x))
    return x


@torch.no_grad()
def hidden_states(model: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    """Token embeddings (B, S) -> the last block's output (B, S, d), in
    the compute dtype, before the final norm."""
    return _blocks(model, tokens, remat=False)


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


def loss_fn(model: Transformer, tokens: torch.Tensor,
            labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy of next-token prediction, differentiable in the
    model's parameters (those with ``requires_grad``): every block
    rematerialised in the backward pass, as the reference's scan of
    checkpointed units.  Refuses a config that does not train on the port
    (``check_trainable``)."""
    check_trainable(model.cfg)
    x = model.final_norm(_blocks(model, tokens, remat=True))
    return cross_entropy(_lm_head(model, x), labels)


def value_and_grad(model: Transformer, tokens: torch.Tensor,
                   labels: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """``loss_fn`` and its gradient in every parameter (whatever their
    ``requires_grad``), the gradient laid out as ``param_tree``."""
    named = list(model.named_parameters())
    frozen = [p for _, p in named if not p.requires_grad]
    for p in frozen:
        p.requires_grad_(True)
    try:
        loss = loss_fn(model, tokens, labels)
        grads = torch.autograd.grad(loss, [p for _, p in named])
    finally:
        for p in frozen:
            p.requires_grad_(False)
    return loss.detach(), param_tree(
        model, {n: g for (n, _), g in zip(named, grads)})


def _tree_path(cfg: ModelConfig, name: str):
    """The reference pytree path of the port's parameter ``name`` and its
    index on the stacked repeat axis (None outside the segments)."""
    parts = name.split(".")
    if parts[0] == "embed_table":
        return ("embed", "table"), None
    if parts[0] == "segments":
        i, layer = int(parts[1]), int(parts[2])
        unit = len(cfg.segments[i].kinds)
        return (("segments", i, f"b{layer % unit}", *parts[3:]),
                layer // unit)
    return tuple(parts), None


def param_tree(model: Transformer, values: dict | None = None) -> dict:
    """The model's parameters -- or ``values``, a {parameter name: tensor}
    map such as their gradients -- in the reference's pytree layout:
    ``{"embed": {"table"}, "final_norm": {"scale"}, "segments": [{"b<j>":
    block j of the unit}], "lm_head"}``, each segment leaf stacked over
    the segment's repeats on axis 0 (copy r of block j is the port's layer
    r * len(kinds) + j).  The tensors are new (detached copies)."""
    cfg = model.cfg
    if values is None:
        values = dict(model.named_parameters())
    stacks: dict = {}
    tree: dict = {"segments": [{} for _ in cfg.segments]}
    for name, t in values.items():
        path, r = _tree_path(cfg, name)
        t = t.detach()
        if r is None:
            _put(tree, path, t.clone())
        else:
            stacks.setdefault(path, {})[r] = t
    for path, rs in stacks.items():
        _put(tree, path, torch.stack([rs[r] for r in range(len(rs))]))
    return tree


def load_param_tree(model: Transformer, tree: dict) -> None:
    """Copy a ``param_tree``-layout tree of tensors (any device and float
    dtype) into the model's parameters, rounding to their dtype."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            path, r = _tree_path(model.cfg, name)
            leaf = tree
            for k in path:
                leaf = leaf[k]
            src = leaf if r is None else leaf[r]
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(src.shape)} != "
                                 f"{tuple(p.shape)}")
            p.copy_(src)


def _put(tree, path, value) -> None:
    for k in path[:-1]:
        tree = tree[k] if isinstance(k, int) else tree.setdefault(k, {})
    tree[path[-1]] = value
