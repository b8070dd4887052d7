from .dit import DenoisingDiT
from .unet import DenoisingVDMUNet
from .utils import actfn_from_str

__all__ = ["DenoisingDiT", "DenoisingVDMUNet", "actfn_from_str"]
