"""qwen2.5-32b [dense] — 64L d_model=5120 40H (kv=8, head_dim=128)
d_ff=27648, vocab=152064, QKV bias.  [hf:Qwen/Qwen2.5 family]  A copy of
``repro.configs.qwen25_32b``."""
from .base import ArchConfig, LayerKind


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen2.5-32b", family="dense",
        n_layers=64, d_model=5120, n_heads=40, n_kv=8, head_dim=128,
        d_ff=27_648, vocab=152_064, pattern=(LayerKind("attn"),),
        fsdp=True,
        qkv_bias=True, tie_embeddings=False, rope_theta=1_000_000.0,
        max_seq=131_072, sub_quadratic=False)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="qwen2.5-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv=2, head_dim=16,
        d_ff=128, vocab=256, pattern=(LayerKind("attn"),),
        qkv_bias=True, tie_embeddings=False, max_seq=128,
        sub_quadratic=False)
