"""paligemma-3b [vlm] — 18L gemma backbone d_model=2048 8H (kv=1,
head_dim=256) d_ff=16384 vocab=257216; SigLIP frontend STUBBED as 256
precomputed patch embeddings forming a bidirectional prefix (prefix-LM).
[arXiv:2407.07726]  A copy of
``repro.configs.paligemma_3b``."""
from .base import ArchConfig, LayerKind


def config() -> ArchConfig:
    return ArchConfig(
        name="paligemma-3b", family="vlm", arch_type="vlm",
        n_layers=18, d_model=2048, n_heads=8, n_kv=1, head_dim=256,
        d_ff=16_384, vocab=257_216, pattern=(LayerKind("attn"),),
        enc_seq=256, zero_centered_norm=True, scale_embed_sqrt_d=True,
        act="gelu_tanh", tie_embeddings=True, max_seq=8192,
        sub_quadratic=False)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="paligemma-smoke", family="vlm", arch_type="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv=1, head_dim=16,
        d_ff=128, vocab=256, pattern=(LayerKind("attn"),),
        enc_seq=8, zero_centered_norm=True, scale_embed_sqrt_d=True,
        act="gelu_tanh", tie_embeddings=True, max_seq=128,
        sub_quadratic=False)
