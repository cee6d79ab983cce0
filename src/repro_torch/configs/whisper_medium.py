"""whisper-medium [audio] -- enc-dec, conv frontend stubbed
[arXiv:2212.04356; unverified].

24L d_model=1024 16H d_ff=4096 vocab=51865. Interpreted as 24 encoder +
24 decoder layers (the real whisper-medium layout); the audio conv
frontend is a STUB -- the caller passes precomputed frame embeddings
(B, 1500, d_model) as ``enc_frames``.
"""
from repro_torch.models.config import ModelConfig, dense_stack


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium",
        d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
        vocab=51865, act="gelu", tie_embeddings=True,
        segments=dense_stack(24),
        encoder_layers=24, encoder_frames=1500,
        frontend="audio",
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium-reduced",
        d_model=96, n_heads=2, n_kv_heads=2, d_ff=192,
        vocab=512, act="gelu", tie_embeddings=True,
        segments=dense_stack(2),
        encoder_layers=2, encoder_frames=30,
        frontend="audio",
        param_dtype="float32", compute_dtype="float32",
    )
