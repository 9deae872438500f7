from .dmvae_config import DMVAEConfig
from .dmvae_model import DMVAE

__all__ = ["DMVAE", "DMVAEConfig"]
