"""qwen1.5-4b [dense] — 40L d_model=2560 20H (kv=20) d_ff=6912,
vocab=151936, QKV bias.  [hf:Qwen/Qwen1.5 family]  A copy of
``repro.configs.qwen15_4b``."""
from .base import ArchConfig, LayerKind


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen1.5-4b", family="dense",
        n_layers=40, d_model=2560, n_heads=20, n_kv=20, head_dim=128,
        d_ff=6912, vocab=151_936, pattern=(LayerKind("attn"),),
        qkv_bias=True, tie_embeddings=False, max_seq=32_768,
        sub_quadratic=False)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="qwen1.5-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv=4, head_dim=16,
        d_ff=128, vocab=256, pattern=(LayerKind("attn"),),
        qkv_bias=True, tie_embeddings=False, max_seq=128,
        sub_quadratic=False)
