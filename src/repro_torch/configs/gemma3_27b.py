"""gemma3-27b [dense-hybrid] — 62L d_model=5376 32H (kv=16, head_dim=128)
d_ff=21504, vocab=262144, 5 local (window 1024) : 1 global, QK-norm,
sandwich norms, 128k context.  [hf:google/gemma-3 family]  A copy of
``repro.configs.gemma3_27b``."""
from .base import ArchConfig, LayerKind


def config() -> ArchConfig:
    return ArchConfig(
        name="gemma3-27b", family="dense",
        n_layers=62, d_model=5376, n_heads=32, n_kv=16, head_dim=128,
        d_ff=21_504, vocab=262_144,
        pattern=(LayerKind("attn", window=1024, rope_theta=10_000.0),) * 5
        + (LayerKind("attn", rope_theta=1_000_000.0),),
        qk_norm=True, zero_centered_norm=True, post_norms=True,
        fsdp=True,
        scale_embed_sqrt_d=True, act="gelu_tanh", tie_embeddings=True,
        max_seq=131_072,
        # 5:1 local:global — local KV is bounded, global layers decode with
        # sequence-sharded KV => eligible for long_500k (see DESIGN.md).
        sub_quadratic=True)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="gemma3-smoke", family="dense",
        n_layers=8, d_model=64, n_heads=4, n_kv=2, head_dim=16,
        d_ff=128, vocab=256,
        pattern=(LayerKind("attn", window=16),) * 2 + (LayerKind("attn"),),
        qk_norm=True, zero_centered_norm=True, post_norms=True,
        scale_embed_sqrt_d=True, act="gelu_tanh", tie_embeddings=True,
        max_seq=128, sub_quadratic=True)
