from .mhvae_config import MHVAEConfig
from .mhvae_model import MHVAE

__all__ = ["MHVAE", "MHVAEConfig"]
