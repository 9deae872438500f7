from .base import BaseModel, BaseMultiVAE, BaseMultiVAEConfig
from .mmvae import MMVAE, MMVAEConfig
from .mvtcae import MVTCAE, MVTCAEConfig

__all__ = ["BaseModel", "BaseMultiVAE", "BaseMultiVAEConfig", "MMVAE",
           "MMVAEConfig", "MVTCAE", "MVTCAEConfig"]
