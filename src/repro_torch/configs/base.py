"""Architecture config schema: a copy of ``repro.configs.base`` (the port
imports nothing of ``repro``), field for field, so that a config of one
package reads the same in the other."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LayerKind:
    """One position in the repeating layer pattern."""
    mixer: str = "attn"          # attn | ssm | rglru
    window: int | None = None    # sliding-window size for local attention
    rope_theta: float | None = None   # override per layer kind (gemma3 global)
    ffn: str = "mlp"             # mlp | moe | none


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int | None = None
    pattern: tuple[LayerKind, ...] = (LayerKind(),)

    # attention details
    qkv_bias: bool = False
    qk_norm: bool = False
    logit_softcap: float | None = None
    rope_theta: float = 10_000.0
    use_rope: bool = True

    # norms / activations
    norm_type: str = "rms"       # rms | layer
    zero_centered_norm: bool = False   # gemma (1+g) RMSNorm
    post_norms: bool = False     # gemma3 sandwich norms
    act: str = "silu"
    gated_mlp: bool = True
    mlp_bias: bool = False

    # embeddings
    tie_embeddings: bool = True
    scale_embed_sqrt_d: bool = False

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_dff: int = 0
    norm_topk: bool = True
    moe_dispatch: str = "nom"    # nom | xla | einsum

    # SSM / RG-LRU
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    lru_width: int | None = None

    # structure
    # Shard params/optimizer over the data axis too (ZeRO-3 analogue) —
    # required when 12 bytes/param does not fit 16-way TP alone (>~20B).
    fsdp: bool = False

    arch_type: str = "decoder"   # decoder | encdec | vlm
    enc_layers: int = 0
    enc_seq: int = 0             # stub frontend length (whisper 1500 frames,
                                 # paligemma 256 patches)
    max_seq: int = 131_072
    sub_quadratic: bool = False  # eligible for long_500k

    # vocab padding: embedding/LM-head tables are padded so the vocab dim
    # shards evenly over the model axis (MaxText-style); targets never hit
    # pad ids, the softmax simply carries dead classes.
    pad_vocab_multiple: int = 256

    @property
    def padded_vocab(self) -> int:
        m = self.pad_vocab_multiple
        return ((self.vocab + m - 1) // m) * m

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    def param_count_estimate(self) -> int:
        """Rough 6N sanity numbers for MODEL_FLOPS (see EXPERIMENTS.md)."""
        hd = self.resolved_head_dim
        attn = self.d_model * hd * (2 * self.n_heads + 2 * self.n_kv)
        mlp = self.d_model * self.d_ff * (3 if self.gated_mlp else 2)
        moe = (self.d_model * self.moe_dff * 3 * self.n_experts
               + self.d_model * self.n_experts) if self.n_experts else 0
        per_layer = 0
        for k in self.pattern:
            if k.mixer == "attn":
                per_layer += attn
            elif k.mixer == "ssm":
                d_in = 2 * self.d_model
                per_layer += self.d_model * (2 * d_in + 2 * self.ssm_state
                                             + d_in // self.ssm_head_dim)
                per_layer += d_in * self.d_model
            elif k.mixer == "rglru":
                w = self.lru_width or self.d_model
                per_layer += 3 * self.d_model * w + 2 * w * w
            if k.ffn == "mlp":
                per_layer += mlp
            elif k.ffn == "moe":
                per_layer += moe
        per_layer /= len(self.pattern)
        total = per_layer * (self.n_layers + self.enc_layers)
        total += self.vocab * self.d_model * (1 if self.tie_embeddings else 2)
        return int(total)

    def active_param_count_estimate(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if not self.n_experts:
            return self.param_count_estimate()
        dense = dataclasses.replace(
            self, n_experts=0,
            pattern=tuple(dataclasses.replace(k, ffn="mlp")
                          for k in self.pattern),
            d_ff=self.moe_dff * self.top_k)
        return dense.param_count_estimate()
