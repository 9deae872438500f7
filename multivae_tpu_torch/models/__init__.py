from .base import BaseModel, BaseMultiVAE, BaseMultiVAEConfig
from .mmvae import MMVAE, MMVAEConfig
from .mmvaePlus import MMVAEPlus, MMVAEPlusConfig
from .mvtcae import MVTCAE, MVTCAEConfig

__all__ = ["BaseModel", "BaseMultiVAE", "BaseMultiVAEConfig", "MMVAE",
           "MMVAEConfig", "MMVAEPlus", "MMVAEPlusConfig", "MVTCAE", "MVTCAEConfig"]
