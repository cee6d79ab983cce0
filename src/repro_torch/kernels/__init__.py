"""Hand-written CUDA kernels of the port and their plain versions.

  bucket_search -- ctypes wrappers of the full-scan and CSR-gather kernels
                   (csrc/bucket_search.cu), with launch counters
  ref           -- plain PyTorch versions of both kernels
  ops           -- layout dispatch (CSR gather + tail scan, or full scan)
  types         -- QueryBatch / StoreView
  _build        -- nvcc build of csrc/*.cu at first use
"""
