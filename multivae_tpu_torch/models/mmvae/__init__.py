from .mmvae_config import MMVAEConfig
from .mmvae_model import MMVAE

__all__ = ["MMVAE", "MMVAEConfig"]
