from .dit import DenoisingDiT
from .mlp import DenoisingMLP
from .unet import DenoisingVDMUNet
from .utils import actfn_from_str

__all__ = ["DenoisingDiT", "DenoisingMLP", "DenoisingVDMUNet", "actfn_from_str"]
