from .cmvae_config import CMVAEConfig
from .cmvae_model import CMVAE

__all__ = ["CMVAE", "CMVAEConfig"]
