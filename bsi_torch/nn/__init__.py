from .attention import Attention2D, repack_qkv_grouped
from .blocks import GroupNormSiLU, ResidualBlock, SimplifiedUNet, feature_modulation
from .fourier import FourierFeatures
from .layers import Conv, Dense, GroupNorm
from .pos_emb import NyquistPositionalEmbedding

__all__ = [
    "Attention2D",
    "Conv",
    "Dense",
    "FourierFeatures",
    "GroupNorm",
    "GroupNormSiLU",
    "NyquistPositionalEmbedding",
    "ResidualBlock",
    "SimplifiedUNet",
    "feature_modulation",
    "repack_qkv_grouped",
]
