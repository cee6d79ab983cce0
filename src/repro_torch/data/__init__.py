"""Datasets and the dedup pre-pass, on torch.

  datasets -- synthetic stand-ins for the paper's Random, Wiki and Image
              datasets (section 4.1)
  dedup    -- near-duplicate detection with the index's hash functions
  pipeline -- the deterministic, resumable token stream of training
"""
from repro_torch.data.datasets import (image_histograms, planted_random,
                                       tfidf_like)
from repro_torch.data.dedup import dedup_embeddings
from repro_torch.data.pipeline import PipelineState, TokenPipeline

__all__ = ["planted_random", "tfidf_like", "image_histograms",
           "TokenPipeline", "PipelineState", "dedup_embeddings"]
