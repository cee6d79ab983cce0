"""Hand-written CUDA kernels of the port and their plain versions.

  bucket_search   -- ctypes wrappers of the full-scan and CSR-gather
                     kernels (csrc/bucket_search.cu), with launch counters
  flash_attention -- ctypes wrapper of the flash-attention kernel
                     (csrc/flash_attention.cu), with a launch counter
  ssd_scan        -- ctypes wrapper of the Mamba-2 SSD chunked-scan kernel
                     (csrc/ssd_scan.cu), with a launch counter
  lsh_hash        -- ctypes wrapper of the p-stable hash kernel
                     (csrc/lsh_hash.cu), with a launch counter
  ref             -- plain PyTorch versions of the kernels
  ops             -- dispatch: the bucket scan by store layout (CSR gather
                     + tail scan, or full scan), attention, the SSD scan
                     and the hash
  types           -- QueryBatch / StoreView
  _build          -- nvcc build of csrc/*.cu at first use
"""
