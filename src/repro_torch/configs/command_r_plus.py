"""command-r-plus-104b [dense] — 64L d_model=12288 96H (kv=8, head_dim=128)
d_ff=33792, vocab=256000, no bias, tied embeddings.
[hf:CohereForAI/c4ai-command-r family]

Adaptation note: Cohere's parallel attn+FFN block is implemented as the
standard sequential residual block (see DESIGN.md §arch).

A copy of ``repro.configs.command_r_plus``."""
from .base import ArchConfig, LayerKind


def config() -> ArchConfig:
    return ArchConfig(
        name="command-r-plus-104b", family="dense",
        n_layers=64, d_model=12_288, n_heads=96, n_kv=8, head_dim=128,
        d_ff=33_792, vocab=256_000, pattern=(LayerKind("attn"),),
        fsdp=True,
        tie_embeddings=True, rope_theta=75_000_000.0, use_rope=True,
        max_seq=131_072, sub_quadratic=False)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="command-r-plus-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=8, n_kv=2, head_dim=8,
        d_ff=128, vocab=256, pattern=(LayerKind("attn"),),
        tie_embeddings=True, max_seq=128, sub_quadratic=False)
