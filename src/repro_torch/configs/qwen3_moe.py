"""qwen3-moe-235b-a22b [moe] — 94L d_model=4096 64H (kv=4, head_dim=128)
MoE 128e top-8, expert d_ff=1536, vocab=151936, QK-norm, untied.
[hf:Qwen/Qwen3-30B-A3B scaled family]  A copy of
``repro.configs.qwen3_moe``."""
from .base import ArchConfig, LayerKind


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen3-moe-235b-a22b", family="moe",
        n_layers=94, d_model=4096, n_heads=64, n_kv=4, head_dim=128,
        d_ff=1536, vocab=151_936, pattern=(LayerKind("attn", ffn="moe"),),
        n_experts=128, top_k=8, moe_dff=1536, norm_topk=True,
        fsdp=True,
        qk_norm=True, tie_embeddings=False, rope_theta=1_000_000.0,
        max_seq=131_072, sub_quadratic=False)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="qwen3-moe-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv=2, head_dim=16,
        d_ff=96, vocab=256, pattern=(LayerKind("attn", ffn="moe"),),
        n_experts=8, top_k=2, moe_dff=96, norm_topk=True, qk_norm=True,
        tie_embeddings=False, moe_dispatch="einsum", max_seq=128,
        sub_quadratic=False)
