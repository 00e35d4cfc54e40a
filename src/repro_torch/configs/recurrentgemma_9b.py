"""recurrentgemma-9b [hybrid] — 38L d_model=4096, RG-LRU + local attention
1:2 (pattern rec,rec,attn window=2048), 16H MQA (kv=1), d_ff=12288 GeGLU,
vocab=256000.  [arXiv:2402.19427]  A copy of
``repro.configs.recurrentgemma_9b``."""
from .base import ArchConfig, LayerKind


def config() -> ArchConfig:
    return ArchConfig(
        name="recurrentgemma-9b", family="hybrid",
        n_layers=38, d_model=4096, n_heads=16, n_kv=1, head_dim=256,
        d_ff=12_288, vocab=256_000,
        pattern=(LayerKind("rglru"), LayerKind("rglru"),
                 LayerKind("attn", window=2048)),
        lru_width=4096, zero_centered_norm=True, scale_embed_sqrt_d=True,
        act="gelu_tanh", tie_embeddings=True, max_seq=1 << 20,
        sub_quadratic=True)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="recurrentgemma-smoke", family="hybrid",
        n_layers=5, d_model=64, n_heads=4, n_kv=1, head_dim=16,
        d_ff=128, vocab=256,
        pattern=(LayerKind("rglru"), LayerKind("rglru"),
                 LayerKind("attn", window=32)),
        lru_width=64, zero_centered_norm=True, scale_embed_sqrt_d=True,
        act="gelu_tanh", tie_embeddings=True, max_seq=256,
        sub_quadratic=True)
