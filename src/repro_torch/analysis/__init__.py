"""The port's contract analysis, the counterpart of ``repro.analysis``.

The paper's central claim is a network bound, and the reference proves it
statically: one fused exchange per phase (insert 1, query 2 -- dispatch
and routed return -- delete 0), work flat in the table count T, no
O(R*N) intermediate, donated store buffers, no host sync on the hot
path.  The port keeps those invariants in its own manifest,
``contracts.json`` (the budgets it shares with the reference's are equal
to them), and checks them by three passes:

- :mod:`repro_torch.analysis.trace_pass` -- a phase of the index runs on
  real tensors under a ``TorchDispatchMode``: exchanges through the
  ``AllToAll`` shim, aten op counts and flatness in T, the largest
  intermediate, 32-bit payloads on the wire (the counterpart of
  ``jaxpr_pass``).
- :mod:`repro_torch.analysis.device_pass` -- store columns written in
  place (donation's counterpart), the bucket kernels' shared memory
  (VMEM's), and on the card the allocator's peak and each phase's host
  syncs (the counterpart of ``hlo_pass``).
- :mod:`repro_torch.analysis.repolint` -- the AST lint over the port.

Run the gate with ``python -m repro_torch.analysis.check`` (on the card
unless ``--device cpu``; ``--skip-trace`` lints and sizes shared memory
with no device).  :mod:`manifest` and :mod:`repolint` import no torch.
"""

from repro_torch.analysis.manifest import CONTRACTS_PATH, load_contracts, repo_root

__all__ = ["CONTRACTS_PATH", "load_contracts", "repo_root"]
