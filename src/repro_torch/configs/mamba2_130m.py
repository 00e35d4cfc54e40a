"""mamba2-130m [ssm] — 24L d_model=768, attention-free SSD blocks,
ssm_state=128, vocab=50280.  [arXiv:2405.21060]  A copy of
``repro.configs.mamba2_130m``."""
from .base import ArchConfig, LayerKind


def config() -> ArchConfig:
    return ArchConfig(
        name="mamba2-130m", family="ssm",
        n_layers=24, d_model=768, n_heads=0, n_kv=0, d_ff=0,
        vocab=50_280, pattern=(LayerKind("ssm", ffn="none"),),
        ssm_state=128, ssm_head_dim=64, tie_embeddings=True,
        max_seq=1 << 20, sub_quadratic=True)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="mamba2-smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=0, n_kv=0, d_ff=0,
        vocab=256, pattern=(LayerKind("ssm", ffn="none"),),
        ssm_state=16, ssm_head_dim=16, ssm_chunk=16, tie_embeddings=True,
        max_seq=256, sub_quadratic=True)
