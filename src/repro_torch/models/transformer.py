"""Model assembly: config-driven decoder-only and encoder-decoder LMs,
every family of the zoo -- dense attention, Mixture-of-Experts (granite-moe,
deepseek-v2-lite with MLA), the attention-free Mamba-2, the RG-LRU hybrid
with sliding-window attention (recurrentgemma), the encoder-decoder with
an audio stub (whisper) and the VLM with a vision stub (pixtral).

A ``Transformer`` holds the embedding table, one ``ModuleList`` of blocks
per segment of the config (the reference stacks each segment's per-layer
parameters on a leading axis and scans over them; here the segment is a
loop over its layers), the encoder where the config has one, the final
norm, and an untied head where the config has one.  ``forward`` runs the
full sequence with no cache and returns the logits and the MoE balance
loss, summed over the blocks (0 for a family without MoE), as the
reference's does.

A ``Block`` mixes with attention (global, sliding-window or MLA) or the
RG-LRU, then, in an encoder-decoder's decoder, cross-attends to the
encoder's output, then applies the gated MLP or the MoE MLP
(``Segment.moe``); an ``SSMBlock`` (mamba2) has no MLP.  The encoder
(``encode``) is ``encoder_layers`` non-causal ATTN blocks over stub frame
embeddings (``enc_frames``, (B, encoder_frames, d)) and its norm; a
vision stub's patch embeddings (``frontend_emb``, (B, P, d)) are
prepended to the token embeddings and their rows dropped before the
head.

Serving: ``init_cache`` lays out the reference's cache pytree -- a list
with one entry a segment, ``{"b<j>": block j's leaves}``, each leaf
stacked over the segment's repeats on axis 0 -- and ``prefill`` and
``decode_step`` fill it in place: each layer writes its own slice of
the stacked leaves (an attention block's K/V at the positions it runs,
a sliding-window block's too, over all Smax positions with the window
as a mask; an MLA block's latent ckv/kpe; an SSM block's conv and SSM
state; an RG-LRU block's conv state and h; a decoder block of an
encoder-decoder its cross-attention K/V ``xk``/``xv`` of the encoder's
frames, filled by ``prefill``; MoE adds no entry), so the tree passes
from call to call unchanged and carries across to and from the
reference (``convert.py``).

Training: ``loss_fn`` is the reference's (cross entropy plus 0.01 times
the balance loss), through a differentiable
forward with the reference's per-block rematerialisation (its
``jax.checkpoint`` of each scanned unit, here ``torch.utils.checkpoint``,
non-reentrant).  Every config trains: the attention families (local
attention, the encoder and cross-attention included) through the flash
kernel and its gradient kernel, the SSM family through the SSD scan and
its gradient kernel, the RG-LRU through autograd of its plain scan.  An
encoder-decoder needs its ``enc_frames``.  ``param_tree`` lays the
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
from repro_torch.models.attention import MLA, Attention, sdpa
from repro_torch.models.config import BlockKind, ModelConfig
from repro_torch.models.layers import (MLP, RMSNorm, cross_entropy, embed,
                                       he_init_, param, unembed)
from repro_torch.models.moe import MoE
from repro_torch.models.rglru import RGLRU, init_rglru_state
from repro_torch.models.ssm import SSM, init_ssm_state, ssm_block


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a block kind the zoo does not have (every
    ``BlockKind`` runs on the port), as the reference's ``_apply_block``
    raises on one."""
    for seg in cfg.segments:
        for kind in seg.kinds:
            BlockKind(kind)


def check_trainable(cfg: ModelConfig) -> None:
    """Raise unless ``cfg`` trains on the port: every config that
    ``check_supported`` admits does (attention and MLA blocks, the
    encoder and cross-attention included, through the flash gradient
    kernel, SSM blocks through the SSD one, the RG-LRU and the MoE MLP
    through plain PyTorch as the reference's plain jnp).  An
    encoder-decoder trains only with its ``enc_frames``, which
    ``loss_fn`` asks for."""
    check_supported(cfg)


class Block(nn.Module):
    """x + mix(norm_mix(x)), then, in an encoder-decoder's decoder, +
    cross(norm_cross(x)), then + mlp(norm_mlp(x)), as the reference's
    ``_init_block`` lays it out: the mixer is ``attn`` (attention, causal
    or not, sliding-window for ``LOCAL_ATTN``; MLA) or ``rglru``, and
    the MLP the MoE one (``moe``) in a segment with ``moe`` set.
    ``forward`` returns (x, the MoE balance loss or None)."""

    def __init__(self, cfg: ModelConfig, kind: BlockKind, use_moe: bool,
                 device=None, *, cross: bool = False, causal: bool = True):
        super().__init__()
        d, dt, eps = cfg.d_model, cfg.pdtype, cfg.norm_eps
        self.cfg = cfg
        self.norm_mix = RMSNorm(d, eps, dt, device)
        if kind == BlockKind.RGLRU:
            self.rglru = RGLRU(cfg, device)
        elif kind == BlockKind.MLA:
            self.attn = MLA(cfg, device)
        else:
            self.attn = Attention(cfg, device, causal=causal, window=(
                cfg.window if kind == BlockKind.LOCAL_ATTN else None))
        if cross:
            self.norm_cross = RMSNorm(d, eps, dt, device)
            self.cross = Attention(cfg, device)
        self.norm_mlp = RMSNorm(d, eps, dt, device)
        if use_moe:
            self.moe = MoE(cfg, device)
        else:
            self.mlp = MLP(d, cfg.d_ff, cfg.act, dt, device)

    def forward(self, x, *, pos0=0, cache=None, enc_out=None):
        """``cache``: the block's leaves, read and written in place (an
        RG-LRU's {"conv", "h"} state is continued and overwritten).
        ``enc_out``: the encoder's output (B, F, d), whose K/V the
        cross-attention computes; None at decode, where it reads the
        cache's ``xk``/``xv``."""
        h = self.norm_mix(x)
        if hasattr(self, "rglru"):
            if cache is None:
                o = self.rglru(h)
            else:
                o, new = self.rglru(h, state=cache)
                for key, t in new.items():
                    cache[key].copy_(t)
        else:
            o = self.attn(h, pos0=pos0, cache=cache)
        x = x + o
        if hasattr(self, "cross"):
            x = x + _cross_attention(self.cross, self.cfg,
                                     self.norm_cross(x), enc_out, cache)
        h = self.norm_mlp(x)
        if hasattr(self, "moe"):
            o, aux = self.moe(h)
            return x + o, aux
        return x + self.mlp(h), None


def _cross_attention(p, cfg: ModelConfig, x, enc_out, cache):
    """Cross-attention, non-causal and without RoPE: queries from x (B,
    S, d), keys and values from the encoder's output (B, F, d), or from
    the cache's ``xk``/``xv`` (B, Hkv, F, hd) when ``enc_out`` is None
    (decode).  Returns (B, S, d)."""
    B, S, _ = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ p.wq).view(B, S, H, hd).transpose(1, 2)
    if enc_out is not None:
        k = (enc_out @ p.wk).view(B, -1, Hkv, hd).transpose(1, 2)
        v = (enc_out @ p.wv).view(B, -1, Hkv, hd).transpose(1, 2)
    else:
        k, v = cache["xk"], cache["xv"]
    out = sdpa(q, k, v, causal=False)
    return out.transpose(1, 2).reshape(B, S, H * hd) @ p.wo


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


def _block(cfg: ModelConfig, kind: BlockKind, use_moe: bool, device):
    """A decoder block of ``kind`` (an SSM block has no MLP, so no MoE
    and no cross-attention either, as the reference's ``_init_block``
    returns before them)."""
    if kind == BlockKind.SSM:
        return SSMBlock(cfg, device)
    return Block(cfg, kind, use_moe, device, cross=cfg.encoder_layers > 0)


class Encoder(nn.Module):
    """The encoder of an encoder-decoder (whisper): ``encoder_layers``
    non-causal ATTN blocks with RoPE, no cross-attention and no cache
    (``segment``), then its RMSNorm (``norm``) -- the reference's
    ``params["encoder"]``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.segment = nn.ModuleList(
            Block(cfg, BlockKind.ATTN, False, device, causal=False)
            for _ in range(cfg.encoder_layers))
        self.norm = RMSNorm(cfg.d_model, cfg.norm_eps, cfg.pdtype, device)


class Transformer(nn.Module):
    """Parameters of a config on ``device`` (``cuda`` unless given;
    raises without a card); uninitialised until ``reset_parameters``
    (``init_params``) or ``convert.py`` fills them."""

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
        self.encoder = (Encoder(cfg, device) if cfg.encoder_layers > 0
                        else None)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's distributions: embedding normal * 0.02, every
        projection normal / sqrt(fan_in), norm scales 1 (and the SSM's,
        the RG-LRU's and the MoE's own, ``SSM.reset_parameters``,
        ``RGLRU.reset_parameters``, ``MoE.reset_parameters``)."""
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


def _call(block, x, remat: bool, **kw):
    """block(x, **kw), rematerialised in the backward pass with
    ``remat`` -> (x, the block's balance loss or None)."""
    if remat:
        return checkpoint(block, x, use_reentrant=False, **kw)
    return block(x, **kw)


def encode(model: Transformer, frames: torch.Tensor,
           remat: bool = False) -> torch.Tensor:
    """Whisper-style encoder over stub frame embeddings (B, F, d) -> its
    output (B, F, d) in the compute dtype: the encoder's blocks, every
    key seen by every frame (the flash kernel, non-causal), then its
    norm."""
    x = frames.to(model.cfg.cdtype)
    for block in model.encoder.segment:
        x, _ = _call(block, x, remat)
    return model.encoder.norm(x)


def _inputs(model: Transformer, tokens, frontend_emb, enc_frames,
            remat: bool = False):
    """(The decoder's input (B, P + S, d): the stub patch embeddings
    ``frontend_emb`` (B, P, d), where given, before the token
    embeddings; the encoder's output or None).  An encoder-decoder
    without ``enc_frames`` raises ``ValueError``."""
    cfg = model.cfg
    x = embed(model.embed_table, tokens).to(cfg.cdtype)
    if frontend_emb is not None:
        x = torch.cat([frontend_emb.to(cfg.cdtype), x], dim=1)
    if model.encoder is None:
        return x, None
    if enc_frames is None:
        raise ValueError(f"{cfg.name} is an encoder-decoder: pass its "
                         f"encoder input as enc_frames (B, "
                         f"{cfg.encoder_frames}, {cfg.d_model})")
    return x, encode(model, enc_frames, remat)


def _blocks(model: Transformer, x: torch.Tensor, enc_out=None,
            remat: bool = False, pos0=0, cache: list | None = None):
    """The decoder's input x (B, S, d) at positions pos0 .. pos0 + S - 1
    through every block -> (the last block's output, the balance loss
    summed over the blocks: a 0-d float32 tensor, 0 without MoE).  With
    ``cache`` (``init_cache``'s tree) each layer reads and writes its own
    slice of it in place; with ``remat`` each block is rematerialised in
    the backward pass; ``enc_out`` goes to every cross-attention."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    extra = {} if enc_out is None else {"enc_out": enc_out}
    for i, blocks in enumerate(model.segments):
        unit = len(model.cfg.segments[i].kinds)
        for layer, block in enumerate(blocks):
            kw = dict(extra)
            if cache is not None:
                kw.update(pos0=pos0, cache={
                    key: t[layer // unit]
                    for key, t in cache[i][f"b{layer % unit}"].items()})
            x, a = _call(block, x, remat, **kw)
            if a is not None:
                aux = aux + a
    return x, aux


@torch.no_grad()
def hidden_states(model: Transformer, tokens: torch.Tensor, *,
                  frontend_emb=None, enc_frames=None) -> torch.Tensor:
    """Token embeddings (B, S) -> the last block's output (B, P + S, d),
    in the compute dtype, before the final norm (P the patch rows of
    ``frontend_emb``, where given; ``enc_frames`` the encoder's input of
    an encoder-decoder)."""
    return _blocks(model, *_inputs(model, tokens, frontend_emb,
                                   enc_frames))[0]


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


def _forward(model: Transformer, tokens, frontend_emb, enc_frames,
             remat: bool):
    """(logits of the token rows, the balance loss): the patch rows of
    ``frontend_emb`` run through the blocks and are dropped before the
    head."""
    x, aux = _blocks(model, *_inputs(model, tokens, frontend_emb,
                                     enc_frames, remat), remat=remat)
    if frontend_emb is not None:
        x = x[:, frontend_emb.shape[1]:]
    return _logits(model, x), aux


@torch.no_grad()
def forward(model: Transformer, tokens: torch.Tensor, *, frontend_emb=None,
            enc_frames=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward -> (logits (B, S, vocab_padded) f32 of the S
    tokens, the MoE balance loss summed over the blocks, 0-d f32; 0
    without MoE).  ``frontend_emb`` (B, P, d): stub patch embeddings
    prepended to the token embeddings (VLM); ``enc_frames`` (B, F, d):
    the encoder's input (audio), which an encoder-decoder needs."""
    return _forward(model, tokens, frontend_emb, enc_frames, False)


# ---------------------------------------------------------------------------
# Serving: the cache, prefill and decode
# ---------------------------------------------------------------------------

def _block_cache(kind: BlockKind, cfg: ModelConfig, batch: int,
                 smax: int) -> dict:
    """One block's cache leaves on the meta device (shapes and dtypes
    only): an attention block's K/V (B, Hkv, Smax, hd) in the compute
    dtype (a sliding-window block's too), an MLA block's latent ckv (B,
    Smax, kv_lora) and kpe (B, Smax, rope_dim), an SSM block's state
    (``init_ssm_state``), an RG-LRU block's (``init_rglru_state``); in
    an encoder-decoder's decoder, besides, the cross-attention's K/V
    ``xk``/``xv`` (B, Hkv, encoder_frames, hd)."""
    if kind == BlockKind.SSM:
        return init_ssm_state(cfg, batch, "meta")
    if kind == BlockKind.RGLRU:
        c = init_rglru_state(cfg, batch, "meta")
    elif kind == BlockKind.MLA:
        m = cfg.mla
        c = {key: torch.empty((batch, smax, width), dtype=cfg.cdtype,
                              device="meta")
             for key, width in (("ckv", m.kv_lora), ("kpe", m.rope_dim))}
    else:
        shape = (batch, cfg.n_kv_heads, smax, cfg.hd)
        c = {"k": torch.empty(shape, dtype=cfg.cdtype, device="meta"),
             "v": torch.empty(shape, dtype=cfg.cdtype, device="meta")}
    if cfg.encoder_layers > 0:
        shape = (batch, cfg.n_kv_heads, cfg.encoder_frames, cfg.hd)
        c["xk"] = torch.empty(shape, dtype=cfg.cdtype, device="meta")
        c["xv"] = torch.empty(shape, dtype=cfg.cdtype, device="meta")
    return c


def init_cache(cfg: ModelConfig, batch: int, smax: int,
               device=None) -> list:
    """A zero cache for ``batch`` sequences of up to ``smax`` positions on
    ``device`` (``cuda`` unless given), in the reference's layout: one
    ``{"b<j>": {leaf: tensor}}`` a segment, each leaf stacked over the
    segment's repeats on axis 0 (copy r of block j is the segment's layer
    r * len(kinds) + j).  A prompt with patch rows takes P + S of the
    Smax positions."""
    check_supported(cfg)
    device = resolve_device(device)
    return [{f"b{j}": {key: torch.zeros((seg.repeat, *t.shape),
                                        dtype=t.dtype, device=device)
                       for key, t in _block_cache(kind, cfg, batch,
                                                  smax).items()}
             for j, kind in enumerate(seg.kinds)}
            for seg in cfg.segments]


def _fill_cross_cache(model: Transformer, cache: list, enc_out) -> None:
    """Every decoder block's cross-attention K/V of the encoder's output
    (B, F, d) into the cache's ``xk``/``xv``, in place."""
    cfg = model.cfg
    B, Hkv, hd = enc_out.shape[0], cfg.n_kv_heads, cfg.hd
    for i, blocks in enumerate(model.segments):
        unit = len(cfg.segments[i].kinds)
        for layer, block in enumerate(blocks):
            leaves = cache[i][f"b{layer % unit}"]
            for key, w in (("xk", block.cross.wk), ("xv", block.cross.wv)):
                leaves[key][layer // unit].copy_(
                    (enc_out @ w).view(B, -1, Hkv, hd).transpose(1, 2))


@torch.no_grad()
def prefill(model: Transformer, tokens: torch.Tensor, cache: list, *,
            frontend_emb=None, enc_frames=None):
    """Run the prompt at positions 0 .. P + S - 1 -- the patch rows of
    ``frontend_emb`` (B, P, d) where given, then the tokens (B, S) --
    filling ``cache`` in place (an encoder-decoder's cross-attention K/V
    of its ``enc_frames`` too).  Returns (the last position's logits (B,
    1, vocab_padded) f32, cache)."""
    x, enc_out = _inputs(model, tokens, frontend_emb, enc_frames)
    if enc_out is not None:
        _fill_cross_cache(model, cache, enc_out)
    x, _ = _blocks(model, x, enc_out, pos0=0, cache=cache)
    return _logits(model, x[:, -1:]), cache


@torch.no_grad()
def decode_step(model: Transformer, token: torch.Tensor, cache: list, pos):
    """One-token decode: token (B, 1) at position ``pos`` (an int or a
    0-d integer tensor, read on the device only) -> (logits (B, 1,
    vocab_padded) f32, cache), the cache updated in place; an
    encoder-decoder's cross-attention reads the K/V ``prefill`` cached."""
    x = embed(model.embed_table, token).to(model.cfg.cdtype)
    return _logits(model, _blocks(model, x, pos0=pos, cache=cache)[0]), cache


def loss_fn(model: Transformer, tokens: torch.Tensor,
            labels: torch.Tensor, *, frontend_emb=None, enc_frames=None,
            aux_weight: float = 0.01) -> torch.Tensor:
    """Mean cross entropy of next-token prediction over the token rows
    plus ``aux_weight`` times the MoE balance loss, differentiable in the
    model's parameters (those with ``requires_grad``): every block, the
    encoder's too, rematerialised in the backward pass, as the
    reference's scan of checkpointed units.  ``frontend_emb`` and
    ``enc_frames`` as ``forward`` takes them.  Refuses a config that does
    not train on the port (``check_trainable``)."""
    check_trainable(model.cfg)
    logits, aux = _forward(model, tokens, frontend_emb, enc_frames, True)
    return cross_entropy(logits, labels) + aux_weight * aux


def value_and_grad(model: Transformer, tokens: torch.Tensor,
                   labels: torch.Tensor, *, frontend_emb=None,
                   enc_frames=None) -> tuple[torch.Tensor, dict]:
    """``loss_fn`` and its gradient in every parameter (whatever their
    ``requires_grad``), the gradient laid out as ``param_tree``."""
    named = list(model.named_parameters())
    frozen = [p for _, p in named if not p.requires_grad]
    for p in frozen:
        p.requires_grad_(True)
    try:
        loss = loss_fn(model, tokens, labels, frontend_emb=frontend_emb,
                       enc_frames=enc_frames)
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
    if parts[:2] == ["encoder", "segment"]:      # one ATTN block a unit
        return ("encoder", "segment", "b0", *parts[3:]), int(parts[2])
    return tuple(parts), None


def param_tree(model: Transformer, values: dict | None = None) -> dict:
    """The model's parameters -- or ``values``, a {parameter name: tensor}
    map such as their gradients -- in the reference's pytree layout:
    ``{"embed": {"table"}, "final_norm": {"scale"}, "segments": [{"b<j>":
    block j of the unit}], "lm_head", "encoder": {"segment": {"b0"},
    "norm"}}``, each segment leaf stacked over the segment's repeats on
    axis 0 (copy r of block j is the port's layer r * len(kinds) + j),
    the encoder's over its layers.  The tensors are new (detached
    copies)."""
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
