"""Model assembly: the decoder-only LM of the dense attention family,
the Mixture-of-Experts family (granite-moe, deepseek-v2-lite with MLA)
and the attention-free Mamba-2 family.

A ``Transformer`` holds the embedding table, one ``ModuleList`` of blocks
per segment of the config (the reference stacks each segment's per-layer
parameters on a leading axis and scans over them; here the segment is a
loop over its layers), the final norm, and an untied head where the
config has one.  ``forward`` runs the full sequence with no cache and
returns the logits and the MoE balance loss, summed over the blocks (0
for a family without MoE), as the reference's does.

The port runs ATTN, MLA and SSM blocks, with a gated MLP or the MoE MLP
(``Segment.moe``).  A config with other block kinds (RG-LRU, local
attention), an encoder or a modality frontend raises
``NotImplementedError`` naming the ROADMAP item that ports it.

Serving: ``init_cache`` lays out the reference's cache pytree -- a list
with one entry a segment, ``{"b<j>": block j's leaves}``, each leaf
stacked over the segment's repeats on axis 0 -- and ``prefill`` and
``decode_step`` fill it in place: each layer writes its own slice of
the stacked leaves (an ATTN block's K/V at the positions it runs, an
MLA block's latent ckv/kpe, an SSM block's conv and SSM state; MoE adds
no entry), so the tree passes from call to call
unchanged and carries across to and from the reference (``convert.py``).

Training: ``loss_fn`` is the reference's (cross entropy plus 0.01 times
the balance loss), through a differentiable
forward with the reference's per-block rematerialisation (its
``jax.checkpoint`` of each scanned unit, here ``torch.utils.checkpoint``,
non-reentrant).  Every ported config trains: the attention families
through the flash kernel and its gradient kernel, the SSM family through
the SSD scan and its gradient kernel.  ``param_tree`` lays the
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
from repro_torch.models.attention import MLA, Attention
from repro_torch.models.config import BlockKind, ModelConfig
from repro_torch.models.layers import (MLP, RMSNorm, cross_entropy, embed,
                                       he_init_, param, unembed)
from repro_torch.models.moe import MoE
from repro_torch.models.ssm import SSM, init_ssm_state, ssm_block


# what is not ported yet -> the ROADMAP Queue 1 item that ports it
_ITEMS = {BlockKind.RGLRU: "11.4b (RG-LRU and local attention)",
          BlockKind.LOCAL_ATTN: "11.4b (RG-LRU and local attention)",
          "frontend": "11.5 (the encoder and modality frontends)"}


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` naming the ROADMAP item of the first
    part of ``cfg`` that is not ported."""
    missing = [k for seg in cfg.segments for k in seg.kinds
               if k not in _PORTED]
    if cfg.encoder_layers or cfg.frontend != "none":
        missing.append("frontend")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: only ATTN, MLA and SSM blocks (with or without "
            f"MoE) and no encoder or frontend are ported to repro_torch "
            f"yet (ROADMAP Queue 1 item {_ITEMS[missing[0]]})")


def check_trainable(cfg: ModelConfig) -> None:
    """Raise unless ``cfg`` trains on the port: every config that
    ``check_supported`` admits does (ATTN and MLA blocks through the
    flash gradient kernel, SSM blocks through the SSD one, the MoE MLP
    through plain PyTorch as the reference's plain jnp)."""
    check_supported(cfg)


class Block(nn.Module):
    """ATTN or MLA block: x + attn(norm_mix(x)), then + mlp(norm_mlp(x)),
    the MLP the MoE one (``moe``) in a segment with ``moe`` set, as the
    reference's ``_init_block`` picks it.  ``forward`` returns (x, the
    MoE balance loss or None)."""

    def __init__(self, cfg: ModelConfig, kind: BlockKind, use_moe: bool,
                 device=None):
        super().__init__()
        d, dt, eps = cfg.d_model, cfg.pdtype, cfg.norm_eps
        self.norm_mix = RMSNorm(d, eps, dt, device)
        self.attn = (MLA if kind == BlockKind.MLA else Attention)(cfg, device)
        self.norm_mlp = RMSNorm(d, eps, dt, device)
        if use_moe:
            self.moe = MoE(cfg, device)
        else:
            self.mlp = MLP(d, cfg.d_ff, cfg.act, dt, device)

    def forward(self, x, *, pos0=0, cache=None):
        x = x + self.attn(self.norm_mix(x), pos0=pos0, cache=cache)
        h = self.norm_mlp(x)
        if hasattr(self, "moe"):
            o, aux = self.moe(h)
            return x + o, aux
        return x + self.mlp(h), None


class SSMBlock(nn.Module):
    """SSM block (mamba2): x + ssm(norm_mix(x)), no MLP sub-block."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.norm_mix = RMSNorm(cfg.d_model, cfg.norm_eps, cfg.pdtype, device)
        self.ssm = SSM(cfg, device)

    def forward(self, x, *, pos0=0, cache=None):
        """``cache``: the block's {"conv", "ssm"} state, continued from and
        overwritten in place (``pos0`` is not needed: the state is the
        position).  Returns (x, None): no balance loss."""
        h = self.norm_mix(x)
        if cache is None:
            return x + self.ssm(h), None
        o, new = ssm_block(self.ssm, self.ssm.cfg, h, state=cache)
        for key, t in new.items():
            cache[key].copy_(t)
        return x + o, None


_PORTED = (BlockKind.ATTN, BlockKind.MLA, BlockKind.SSM)


def _block(cfg: ModelConfig, kind: BlockKind, use_moe: bool, device):
    """A block of ``kind`` (an SSM block has no MLP, so no MoE either, as
    the reference's ``_init_block`` returns before it)."""
    if kind == BlockKind.SSM:
        return SSMBlock(cfg, device)
    return Block(cfg, kind, use_moe, device)


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
            nn.ModuleList(_block(cfg, kind, seg.moe, device)
                          for _ in range(seg.repeat) for kind in seg.kinds)
            for seg in cfg.segments)
        self.lm_head = (None if cfg.tie_embeddings else
                        param(d, cfg.vocab_padded, dtype=dt, device=device))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's distributions: embedding normal * 0.02, every
        projection normal / sqrt(fan_in), norm scales 1 (and the SSM's
        and the MoE's own, ``SSM.reset_parameters``,
        ``MoE.reset_parameters``)."""
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


def _blocks(model: Transformer, tokens: torch.Tensor, remat: bool = False,
            pos0=0, cache: list | None = None):
    """Tokens (B, S) at positions pos0 .. pos0 + S - 1 through every
    block -> (the last block's output, the balance loss summed over the
    blocks: a 0-d float32 tensor, 0 without MoE).  With ``cache``
    (``init_cache``'s tree) each layer reads and writes its own slice of
    it in place; with ``remat`` each block is rematerialised in the
    backward pass."""
    x = embed(model.embed_table, tokens).to(model.cfg.cdtype)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, blocks in enumerate(model.segments):
        unit = len(model.cfg.segments[i].kinds)
        for layer, block in enumerate(blocks):
            kw = {} if cache is None else {"pos0": pos0, "cache": {
                key: t[layer // unit]
                for key, t in cache[i][f"b{layer % unit}"].items()}}
            x, a = (checkpoint(block, x, use_reentrant=False, **kw) if remat
                    else block(x, **kw))
            if a is not None:
                aux = aux + a
    return x, aux


@torch.no_grad()
def hidden_states(model: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    """Token embeddings (B, S) -> the last block's output (B, S, d), in
    the compute dtype, before the final norm."""
    return _blocks(model, tokens)[0]


def _logits(model: Transformer, x):
    """The last block's output (B, S, d) -> logits (B, S, vocab_padded)
    f32: the final norm, then the head."""
    cfg = model.cfg
    head = model.embed_table.T if cfg.tie_embeddings else model.lm_head
    logits = unembed(head, model.final_norm(x), cfg.logit_softcap)
    if cfg.vocab_padded != cfg.vocab:   # mask padded vocab rows
        pad = torch.arange(cfg.vocab_padded, device=x.device) >= cfg.vocab
        logits = logits.masked_fill(pad, -1e30)
    return logits


@torch.no_grad()
def forward(model: Transformer, tokens: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward -> (logits (B, S, vocab_padded) f32, the MoE
    balance loss summed over the blocks, 0-d f32; 0 without MoE)."""
    x, aux = _blocks(model, tokens)
    return _logits(model, x), aux


# ---------------------------------------------------------------------------
# Serving: the cache, prefill and decode
# ---------------------------------------------------------------------------

def _block_cache(kind: BlockKind, cfg: ModelConfig, batch: int,
                 smax: int) -> dict:
    """One block's cache leaves on the meta device (shapes and dtypes
    only): an ATTN block's K/V (B, Hkv, Smax, hd) in the compute dtype,
    an MLA block's latent ckv (B, Smax, kv_lora) and kpe (B, Smax,
    rope_dim), an SSM block's state (``init_ssm_state``)."""
    if kind == BlockKind.SSM:
        return init_ssm_state(cfg, batch, "meta")
    if kind == BlockKind.MLA:
        m = cfg.mla
        return {key: torch.empty((batch, smax, width), dtype=cfg.cdtype,
                                 device="meta")
                for key, width in (("ckv", m.kv_lora), ("kpe", m.rope_dim))}
    shape = (batch, cfg.n_kv_heads, smax, cfg.hd)
    return {"k": torch.empty(shape, dtype=cfg.cdtype, device="meta"),
            "v": torch.empty(shape, dtype=cfg.cdtype, device="meta")}


def init_cache(cfg: ModelConfig, batch: int, smax: int,
               device=None) -> list:
    """A zero cache for ``batch`` sequences of up to ``smax`` positions on
    ``device`` (``cuda`` unless given), in the reference's layout: one
    ``{"b<j>": {leaf: tensor}}`` a segment, each leaf stacked over the
    segment's repeats on axis 0 (copy r of block j is the segment's layer
    r * len(kinds) + j).  Raises ``NotImplementedError`` naming the
    ROADMAP item for a config the port does not run."""
    check_supported(cfg)
    device = resolve_device(device)
    return [{f"b{j}": {key: torch.zeros((seg.repeat, *t.shape),
                                        dtype=t.dtype, device=device)
                       for key, t in _block_cache(kind, cfg, batch,
                                                  smax).items()}
             for j, kind in enumerate(seg.kinds)}
            for seg in cfg.segments]


@torch.no_grad()
def prefill(model: Transformer, tokens: torch.Tensor, cache: list):
    """Run the prompt tokens (B, S) at positions 0 .. S-1, filling
    ``cache`` in place.  Returns (the last position's logits (B, 1,
    vocab_padded) f32, cache)."""
    x, _ = _blocks(model, tokens, pos0=0, cache=cache)
    return _logits(model, x[:, -1:]), cache


@torch.no_grad()
def decode_step(model: Transformer, token: torch.Tensor, cache: list, pos):
    """One-token decode: token (B, 1) at position ``pos`` (an int or a
    0-d integer tensor, read on the device only) -> (logits (B, 1,
    vocab_padded) f32, cache), the cache updated in place."""
    return _logits(model, _blocks(model, token, pos0=pos,
                                  cache=cache)[0]), cache


def loss_fn(model: Transformer, tokens: torch.Tensor,
            labels: torch.Tensor, aux_weight: float = 0.01) -> torch.Tensor:
    """Mean cross entropy of next-token prediction plus ``aux_weight``
    times the MoE balance loss, differentiable in the model's parameters
    (those with ``requires_grad``): every block rematerialised in the
    backward pass, as the reference's scan of checkpointed units.
    Refuses a config that does not train on the port
    (``check_trainable``)."""
    check_trainable(model.cfg)
    x, aux = _blocks(model, tokens, remat=True)
    return cross_entropy(_logits(model, x), labels) + aux_weight * aux


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
