"""The port's model stack (counterpart of ``repro.models``): the
decoder of the recurrentgemma and mamba2 families — RMSNorm, embedding,
RoPE, MQA attention through the flash-attention kernel, the RG-LRU
recurrent block through the RG-LRU scan kernel, the Mamba-2 mixer through
the SSD scan kernel, the GeGLU MLP — and the reference-weight
converter."""
from .attention import Attention, AttentionConfig
from .blocks import DecoderLayer, LayerStack
from .common import COMPUTE_DTYPE, PARAM_DTYPE, Embed, RMSNorm
from .convert import params_from_reference
from .lm import CausalLM, make_model
from .mlp import MLP, MLPConfig
from .rglru import RGLRU, RecurrentBlock, RGLRUConfig
from .ssm import Mamba2, SSMConfig

__all__ = ["Attention", "AttentionConfig", "DecoderLayer", "LayerStack",
           "COMPUTE_DTYPE", "PARAM_DTYPE", "Embed", "RMSNorm",
           "params_from_reference", "CausalLM", "make_model", "MLP",
           "MLPConfig", "RGLRU", "RecurrentBlock", "RGLRUConfig", "Mamba2",
           "SSMConfig"]
