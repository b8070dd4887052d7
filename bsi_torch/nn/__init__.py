from .attention import Attention2D, TokenAttention, repack_qkv_grouped
from .blocks import GroupNormSiLU, ResidualBlock, SimplifiedUNet, feature_modulation
from .fourier import FourierFeatures
from .layers import Conv, Dense, GroupNorm, LayerNorm
from .mlp import MLP
from .pos_emb import NyquistPositionalEmbedding

__all__ = [
    "Attention2D",
    "Conv",
    "Dense",
    "FourierFeatures",
    "GroupNorm",
    "GroupNormSiLU",
    "LayerNorm",
    "MLP",
    "NyquistPositionalEmbedding",
    "ResidualBlock",
    "SimplifiedUNet",
    "TokenAttention",
    "feature_modulation",
    "repack_qkv_grouped",
]
