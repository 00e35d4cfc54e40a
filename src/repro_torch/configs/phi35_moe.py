"""phi3.5-moe-42b-a6.6b [moe] — 32L d_model=4096 32H (kv=8) MoE 16e top-2,
expert d_ff=6400, vocab=32064.  [hf:microsoft/Phi-3.5-MoE-instruct]  A copy of
``repro.configs.phi35_moe``."""
from .base import ArchConfig, LayerKind


def config() -> ArchConfig:
    return ArchConfig(
        name="phi3.5-moe-42b-a6.6b", family="moe",
        n_layers=32, d_model=4096, n_heads=32, n_kv=8, d_ff=6400,
        vocab=32064, pattern=(LayerKind("attn", ffn="moe"),),
        fsdp=True,
        n_experts=16, top_k=2, moe_dff=6400, tie_embeddings=False,
        max_seq=131_072, sub_quadratic=False)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="phi3.5-moe-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128,
        vocab=256, pattern=(LayerKind("attn", ffn="moe"),),
        n_experts=4, top_k=2, moe_dff=128, tie_embeddings=False,
        moe_dispatch="einsum", max_seq=128, sub_quadratic=False)
