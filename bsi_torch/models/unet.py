"""VDM-style U-Net denoiser (no down/upsampling).

Counterpart of ``bsi_tpu/models/unet.py``. Inputs and outputs are NHWC, as
in the JAX package; inside, feature maps are NCHW in ``channels_last``
memory format, so the conversions at the boundary are views.

With ``dtype=torch.bfloat16`` the parameters stay f32 and every layer casts
its input and parameters to bf16, as flax does: the Fourier features and the
timestep embedding are computed on the f32 inputs, the cast happens at the
``encode`` conv (and the first Dense of the timestep MLP), and the output is
bf16.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from bsi_torch.core.common import resolve_device
from bsi_torch.nn import Conv, Dense, FourierFeatures, NyquistPositionalEmbedding, SimplifiedUNet

from .utils import actfn_from_str


class DenoisingVDMUNet(nn.Module):
    """U-Net as in the VDM paper, without resampling.

    Args:
        data_shape: (H, W, C) image shape.
        pos_emb: Nyquist embedding for the timestep.
        actfn: Activation name (silu/gelu/relu/softplus/tanh).
        dim: Feature width of every block.
        levels: Number of down (= up) residual blocks.
        pos_emb_mult: Conditioning width = pos_emb.size * pos_emb_mult.
        n_attention_heads: Heads of the centre attention.
        dropout: Dropout rate inside the residual blocks, active in ``train()``.
        downsampling_attention: An attention tail on every residual block,
            each over S = H*W pixels (K1 above 512 pixels, K5f at or below).
            Raises with silu, which the JAX module cannot build.
        fourier_features: Optional per-pixel Fourier features of the input.
        dtype: Compute dtype (parameters stay f32).
        device: Where the parameters live; ``None`` means the card.
    """

    def __init__(
        self,
        data_shape: tuple[int, int, int],
        pos_emb: NyquistPositionalEmbedding,
        actfn: str = "silu",
        dim: int = 128,
        levels: int = 32,
        pos_emb_mult: int = 4,
        n_attention_heads: int = 1,
        dropout: float | None = None,
        downsampling_attention: bool = False,
        fourier_features: FourierFeatures | None = None,
        dtype: torch.dtype | None = None,
        device: torch.device | str | None = None,
    ):
        super().__init__()
        if len(data_shape) != 3:
            raise ValueError("DenoisingVDMUNet only supports 2D image data (H, W, C)")
        if downsampling_attention and actfn_from_str(actfn) is F.silu:
            # flax refuses this model: the JAX block names its fused norm and the tail's both "GroupNorm_0".
            raise ValueError("downsampling_attention is not supported with silu")
        device = resolve_device(device)
        self.data_shape = tuple(data_shape)
        self.pos_emb = pos_emb
        self.fourier_features = fourier_features
        self.act = actfn_from_str(actfn)
        channels = data_shape[-1]
        in_channels = channels * (1 + (fourier_features.n_features() if fourier_features else 0))
        c_dim = pos_emb.size * pos_emb_mult
        kw = dict(dtype=dtype, device=device)
        self.pos_map_1 = Dense(pos_emb.size, c_dim, **kw)
        self.pos_map_2 = Dense(c_dim, c_dim, **kw)
        self.encode = Conv(in_channels, dim, 3, **kw)
        self.unet = SimplifiedUNet(
            dim, levels, c_dim, actfn=self.act, dropout=dropout,
            downsampling_attention=downsampling_attention, attention_heads=n_attention_heads, **kw,
        )
        self.decode = Conv(dim, channels, 1, **kw)

    def forward(self, mu: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """``mu`` [B, H, W, C] and ``t`` [B] -> prediction [B, H, W, C]."""
        x = mu
        if self.fourier_features is not None:
            x = torch.cat([x, self.fourier_features(mu)], dim=-1)
        c = self.act(self.pos_map_1(self.pos_emb(t)))
        c = self.act(self.pos_map_2(c))
        # NHWC -> NCHW: a contiguous NHWC tensor permuted is channels_last.
        h = self.encode(x.contiguous().permute(0, 3, 1, 2))
        h = self.unet(h, c)
        return self.decode(h).permute(0, 2, 3, 1)
