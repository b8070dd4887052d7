from .unet import DenoisingVDMUNet
from .utils import actfn_from_str

__all__ = ["DenoisingVDMUNet", "actfn_from_str"]
