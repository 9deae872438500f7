from .base import BaseModel, BaseMultiVAE, BaseMultiVAEConfig
from .mmvae import MMVAE, MMVAEConfig

__all__ = ["BaseModel", "BaseMultiVAE", "BaseMultiVAEConfig", "MMVAE",
           "MMVAEConfig"]
