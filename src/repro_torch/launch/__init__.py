"""Drivers and tooling of the port, for one card.

  train, serve   -- the training and serving command lines
  steps          -- the reference's cells (``SHAPES``) and their train,
                    prefill and decode steps (``build_step``)
  dryrun         -- every cell on the meta device: memory, FLOPs, bytes,
                    kernel launches and the roofline, no card needed
  op_cost        -- the dry run's counter (the reference's ``hlo_cost``)
  hlo_analysis   -- the H100's roofline, ``model_flops`` and the kernels'
                    cost functions
  mesh           -- ``make_production_mesh``: the one-card layout

No counterpart, each for one card:
  ``repro.compat``        -- jax version shims (``shard_map``,
                             ``make_mesh``): there is no jax;
  ``repro.models.pspec``  -- activation sharding constraints, inert in the
                             reference until ``set_axes``; one card is that
                             inactive state;
  ``repro.launch.sharding`` -- per-leaf partition rules: one card holds
                             every leaf whole, so per-device bytes are the
                             whole bytes the dry run counts;
  ``_setup_pspec``'s ``REPRO_LAYOUT`` and ``REPRO_SEQ_SHARD`` knobs
                             (``repro/launch/steps.py``): no layout to
                             choose on one device;
  ``hlo_analysis.collective_bytes`` -- no HLO; the index's exchanges are
                             counted by the ``AllToAll`` shim.
"""
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import (BuiltStep, build_decode_step,
                                      build_prefill_step, build_step,
                                      build_train_step)

__all__ = ["make_production_mesh", "BuiltStep", "build_step",
           "build_train_step", "build_prefill_step", "build_decode_step"]
