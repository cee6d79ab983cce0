"""Hand-written CUDA kernels of the port and their plain versions.

  bucket_search   -- ctypes wrappers of the full-scan and CSR-gather
                     kernels (csrc/bucket_search.cu), with launch counters
  flash_attention -- ctypes wrapper of the flash-attention kernel
                     (csrc/flash_attention.cu), with a launch counter
  ssd_scan        -- ctypes wrapper of the Mamba-2 SSD chunked-scan kernel
                     (csrc/ssd_scan.cu), with a launch counter
  lsh_hash        -- ctypes wrapper of the p-stable hash kernel
                     (csrc/lsh_hash.cu, bitwise the index's hash_h, which
                     hashes through it), its plan, a launch counter
  ref             -- plain PyTorch versions of the kernels
  ops             -- dispatch: the bucket scan by store layout (CSR gather
                     + tail scan, or full scan), attention, the SSD scan
                     and the hash
  types           -- QueryBatch / StoreView
  _build          -- nvcc build of csrc/*.cu at first use
"""
import sys
from types import ModuleType

from repro_torch.kernels import ops
from repro_torch.kernels.ops import csr_probe_spans
from repro_torch.kernels.types import QueryBatch, StoreView


class _EntryModule(ModuleType):
    """A kernel's module that is also its ``ops`` entry point.  The
    reference exports ``bucket_search``, ``flash_attention``, ``lsh_hash``
    and ``ssd_scan`` from this package as the ``ops`` functions, where the
    port's own code and tests reach the modules of the same names (their
    wrappers, plans and launch counters): calling the module calls the
    function, so both hold."""

    def __call__(self, *args, **kwargs):
        return getattr(ops, self.__name__.rsplit(".", 1)[1])(*args, **kwargs)


for _name in ("bucket_search", "flash_attention", "lsh_hash", "ssd_scan"):
    sys.modules[f"{__name__}.{_name}"].__class__ = _EntryModule

__all__ = ["QueryBatch", "StoreView", "bucket_search", "csr_probe_spans",
           "flash_attention", "lsh_hash", "ssd_scan"]
