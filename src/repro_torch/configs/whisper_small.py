"""whisper-small [audio] — enc-dec, conv frontend stubbed (precomputed
1500-frame embeddings). 12L/12L d_model=768 12H (kv=12) d_ff=3072
vocab=51865.  [arXiv:2212.04356]

Adaptation note (DESIGN.md §arch): learned/sinusoidal positions are
substituted with RoPE on the backbone (parameter-neutral stand-in).

A copy of ``repro.configs.whisper_small``."""
from .base import ArchConfig, LayerKind


def config() -> ArchConfig:
    return ArchConfig(
        name="whisper-small", family="audio", arch_type="encdec",
        n_layers=12, enc_layers=12, enc_seq=1500,
        d_model=768, n_heads=12, n_kv=12, d_ff=3072, vocab=51865,
        pattern=(LayerKind("attn"),),
        norm_type="layer", act="gelu", gated_mlp=False, mlp_bias=True,
        qkv_bias=True, tie_embeddings=True, max_seq=32_768,
        sub_quadratic=False)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="whisper-small-smoke", family="audio", arch_type="encdec",
        n_layers=2, enc_layers=2, enc_seq=16,
        d_model=64, n_heads=4, n_kv=4, d_ff=128, vocab=256,
        pattern=(LayerKind("attn"),),
        norm_type="layer", act="gelu", gated_mlp=False, mlp_bias=True,
        qkv_bias=True, tie_embeddings=True, max_seq=128,
        sub_quadratic=False)
