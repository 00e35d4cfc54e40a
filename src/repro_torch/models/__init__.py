"""The port's model stack (counterpart of ``repro.models``): the
recurrentgemma family's decoder — RMSNorm, embedding, RoPE, MQA attention
through the flash-attention kernel, the RG-LRU recurrent block through the
RG-LRU scan kernel, the GeGLU MLP — and the reference-weight converter."""
from .attention import Attention, AttentionConfig
from .blocks import DecoderLayer, LayerStack
from .common import COMPUTE_DTYPE, PARAM_DTYPE, Embed, RMSNorm
from .convert import params_from_reference
from .lm import CausalLM, make_model
from .mlp import MLP, MLPConfig
from .rglru import RGLRU, RecurrentBlock, RGLRUConfig

__all__ = ["Attention", "AttentionConfig", "DecoderLayer", "LayerStack",
           "COMPUTE_DTYPE", "PARAM_DTYPE", "Embed", "RMSNorm",
           "params_from_reference", "CausalLM", "make_model", "MLP",
           "MLPConfig", "RGLRU", "RecurrentBlock", "RGLRUConfig"]
