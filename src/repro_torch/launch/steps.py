"""Train / prefill / decode steps on one card, and meta-device stand-ins
for their inputs at every (architecture x assigned shape): the
reference's ``repro.launch.steps``.  The dry run (``launch/dryrun.py``)
runs these steps on the meta device, allocating nothing.

The cells -- ``SHAPES``, ``TRAIN_MICROBATCHES`` and the skip rule
``shape_applicable`` -- are the reference's, as they are.  A step is a
plain function over the port's model and state; ``BuiltStep.args`` are
its arguments on the meta device, in order, and a caller on the card
passes its own in their place:

  train    fn(model, params, opt_state, tokens, labels, *extra)
           -> (params, opt_state, loss, {"grad_norm", "lr"})
  prefill  fn(model, cache, tokens, *extra) -> (logits, cache)
  decode   fn(model, cache, token, pos) -> (logits, cache)

``model`` (a ``Transformer``) holds the parameters a prefill or decode
step reads; a train step copies ``params`` (the reference's pytree, as
``launch/train.py`` keeps its state) into it, as ``train.make_step``
does.  ``extra`` is ``frontend_emb`` of a vision stub or ``enc_frames``
of an audio stub, where the config has one.

Differences from the reference, each for one card:
* no shardings, no ``donate_argnums`` to give (``donate`` records which
  arguments the reference donates) and no ``use_kernel``: the kernels run
  on the card, their plain versions on the CPU, and the card's route on
  meta tensors;
* the layout: the reference's ``_setup_pspec`` (``REPRO_LAYOUT``,
  ``REPRO_SEQ_SHARD``) has nothing to lay out on one device.  Its "auto"
  layout would pick FSDP for every train cell of a one-device mesh and
  then force one microbatch, the whole 256 x 4,096 batch of ``train_4k``
  in one; the port keeps the caller's ``microbatches``
  (``TRAIN_MICROBATCHES`` by default);
* cuts: ``batch`` cuts a shape's global batch, and the train builder
  takes ``launch/train.py``'s ``--layers`` cut (``layers``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch import optim
from repro_torch.launch import op_cost
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.train import cut_depth
from repro_torch.models import (Transformer, check_trainable, decode_step,
                                init_cache, load_param_tree, param_tree,
                                prefill, value_and_grad)
from repro_torch.models.config import ModelConfig
from repro_torch.tree import tree_map

# ---------------------------------------------------------------------------
# Assigned input shapes (seq_len, global_batch, kind)
# ---------------------------------------------------------------------------

SHAPES = {
    "train_4k":    dict(seq=4096,    batch=256, kind="train"),
    "prefill_32k": dict(seq=32768,   batch=32,  kind="prefill"),
    "decode_32k":  dict(seq=32768,   batch=128, kind="decode"),
    "long_500k":   dict(seq=524288,  batch=1,   kind="decode"),
}

# per-shape microbatch counts for training (memory control)
TRAIN_MICROBATCHES = 8


def shape_applicable(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """long_500k only runs for sub-quadratic archs (the reference's skip
    policy and reason)."""
    if shape == "long_500k" and not cfg.is_subquadratic():
        return False, ("full-attention arch: 512k decode would need a "
                       "524288-length dense KV cache + O(S) attention per "
                       "token; skipped per assignment (sub-quadratic archs "
                       "only)")
    return True, ""


# ---------------------------------------------------------------------------
# Input specs (meta tensors; no allocation)
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape: str, *,
                batch: Optional[int] = None) -> dict:
    """Model inputs for the given assigned shape, as meta tensors (its
    global batch cut to ``batch`` where given)."""
    s = SHAPES[shape]
    B, S = batch or s["batch"], s["seq"]
    i32 = torch.int32

    def spec(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")

    specs: dict[str, Any] = {}
    if s["kind"] == "train":
        specs["tokens"] = spec((B, S), i32)
        specs["labels"] = spec((B, S), i32)
    elif s["kind"] == "prefill":
        specs["tokens"] = spec((B, S), i32)
    else:  # decode: one new token against an S-long cache
        specs["tokens"] = spec((B, 1), i32)
        specs["pos"] = spec((), i32)
    if cfg.frontend == "vision" and s["kind"] != "decode":
        specs["frontend_emb"] = spec(
            (B, cfg.frontend_tokens, cfg.d_model), cfg.cdtype)
    if cfg.frontend == "audio" and s["kind"] != "decode":
        specs["enc_frames"] = spec(
            (B, cfg.encoder_frames, cfg.d_model), cfg.cdtype)
    return specs


def abstract_model(cfg: ModelConfig) -> Transformer:
    """The model's parameters on the meta device."""
    return Transformer(cfg, device="meta")


def abstract_params(cfg: ModelConfig) -> dict:
    """The parameter pytree (the reference's layout) on the meta device."""
    return param_tree(abstract_model(cfg))


def abstract_cache(cfg: ModelConfig, batch: int, smax: int) -> list:
    return init_cache(cfg, batch, smax, device="meta")


def abstract_opt_state(params_shape) -> optim.OptState:
    return optim.init(params_shape)


# ---------------------------------------------------------------------------
# Step builders
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BuiltStep:
    fn: Any                 # the step function
    args: tuple             # its arguments on the meta device, in order
    donate: tuple = ()      # the arguments the reference donates


def _one_card(mesh: Mesh) -> None:
    if mesh.size != 1:
        raise ValueError(f"the port's steps run on one card, not a mesh of "
                         f"{mesh.size}")


def _extra(cfg: ModelConfig, specs: dict) -> tuple[str, ...]:
    """The names of the stub frontend's inputs, in argument order."""
    return tuple(k for k in ("frontend_emb", "enc_frames") if k in specs)


def build_train_step(cfg: ModelConfig, mesh: Mesh, shape: str,
                     microbatches: int = TRAIN_MICROBATCHES,
                     opt_cfg: Optional[optim.AdamWConfig] = None, *,
                     layers: Optional[int] = None,
                     batch: Optional[int] = None) -> BuiltStep:
    """The reference's train step: the loss and gradient of each of
    ``microbatches`` slices of the batch, the gradients summed in float32,
    divided by the count and applied by AdamW.  ``layers`` cuts the
    config to its first N blocks (``launch/train.py``'s ``--layers``)."""
    _one_card(mesh)
    opt_cfg = opt_cfg or optim.AdamWConfig()
    cfg = cut_depth(cfg, layers)
    check_trainable(cfg)
    specs = input_specs(cfg, shape, batch=batch)
    B = specs["tokens"].shape[0]
    if microbatches < 1 or B % microbatches:
        raise ValueError(f"batch {B} is not a multiple of {microbatches} "
                         f"microbatches")
    names = _extra(cfg, specs)
    model = abstract_model(cfg)
    params = param_tree(model)

    def train_step(model, params, opt_state, tokens, labels, *extra):
        load_param_tree(model, params)
        mb = microbatches
        n = tokens.shape[0] // mb
        g_acc = tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params)
        l_acc = torch.zeros((), dtype=torch.float32, device=tokens.device)
        # the microbatches do the same work: the dry run counts one mb times
        with op_cost.trips(mb, tokens) as runs:
            for i in range(runs):
                rows = slice(i * n, (i + 1) * n)
                loss, grads = value_and_grad(
                    model, tokens[rows], labels[rows],
                    **{k: e[rows] for k, e in zip(names, extra)})
                g_acc = tree_map(lambda a, g: a + g.to(torch.float32),
                                 g_acc, grads)
                l_acc = l_acc + loss
                del loss, grads
        grads = tree_map(lambda g: g / mb, g_acc)
        del g_acc
        params, opt_state, metrics = optim.update(opt_cfg, grads, opt_state,
                                                  params)
        return params, opt_state, l_acc / mb, metrics

    args = (model, params, abstract_opt_state(params), specs["tokens"],
            specs["labels"], *(specs[k] for k in names))
    return BuiltStep(fn=train_step, args=args, donate=(1, 2))


def build_prefill_step(cfg: ModelConfig, mesh: Mesh, shape: str, *,
                       batch: Optional[int] = None) -> BuiltStep:
    """The prompt (after a vision stub's patches) into a cache of its own
    length."""
    _one_card(mesh)
    specs = input_specs(cfg, shape, batch=batch)
    B, S = specs["tokens"].shape
    smax = S + (cfg.frontend_tokens if cfg.frontend == "vision" else 0)
    names = _extra(cfg, specs)

    def prefill_step(model, cache, tokens, *extra):
        return prefill(model, tokens, cache, **dict(zip(names, extra)))

    args = (abstract_model(cfg), abstract_cache(cfg, B, smax),
            specs["tokens"], *(specs[k] for k in names))
    return BuiltStep(fn=prefill_step, args=args, donate=(1,))


def build_decode_step(cfg: ModelConfig, mesh: Mesh, shape: str, *,
                      batch: Optional[int] = None) -> BuiltStep:
    """One token against a cache of the shape's length."""
    _one_card(mesh)
    specs = input_specs(cfg, shape, batch=batch)
    s = SHAPES[shape]
    B, S = batch or s["batch"], s["seq"]

    def serve_step(model, cache, token, pos):
        return decode_step(model, token, cache, pos)

    args = (abstract_model(cfg), abstract_cache(cfg, B, S),
            specs["tokens"], specs["pos"])
    return BuiltStep(fn=serve_step, args=args, donate=(1,))


def build_step(cfg: ModelConfig, mesh: Mesh, shape: str, *,
               batch: Optional[int] = None, **kw) -> BuiltStep:
    """The shape's step; ``kw`` (``microbatches``, ``opt_cfg``,
    ``layers``) goes to the train builder, as the reference's."""
    kind = SHAPES[shape]["kind"]
    if kind == "train":
        return build_train_step(cfg, mesh, shape, batch=batch, **kw)
    if kind == "prefill":
        return build_prefill_step(cfg, mesh, shape, batch=batch)
    return build_decode_step(cfg, mesh, shape, batch=batch)
