"""The port's model stack (counterpart of ``repro.models``): the
decoder of the recurrentgemma, mamba2 and dense-attention (qwen1.5,
qwen2.5, command-r-plus, gemma3) families — RMSNorm (with gemma3's
sandwich norms), embedding, RoPE, GQA/MQA attention with QKV bias, QK
norm and sliding windows through the flash-attention kernel, the RG-LRU
recurrent block through the RG-LRU scan kernel, the Mamba-2 mixer through
the SSD scan kernel, the gated MLP, tied or untied heads — and the
reference-weight converter.  ``make_model`` raises
``NotImplementedError`` for the archs not ported yet (paligemma, the two
MoE configs, whisper: ``lm.check_supported``)."""
from .attention import Attention, AttentionConfig
from .blocks import DecoderLayer, LayerStack
from .common import COMPUTE_DTYPE, PARAM_DTYPE, Embed, RMSNorm
from .convert import params_from_reference
from .lm import CausalLM, LMHead, make_model
from .mlp import MLP, MLPConfig
from .rglru import RGLRU, RecurrentBlock, RGLRUConfig
from .ssm import Mamba2, SSMConfig

__all__ = ["Attention", "AttentionConfig", "DecoderLayer", "LayerStack",
           "COMPUTE_DTYPE", "PARAM_DTYPE", "Embed", "RMSNorm",
           "params_from_reference", "CausalLM", "LMHead", "make_model", "MLP",
           "MLPConfig", "RGLRU", "RecurrentBlock", "RGLRUConfig", "Mamba2",
           "SSMConfig"]
