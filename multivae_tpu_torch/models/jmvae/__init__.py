from .jmvae_config import JMVAEConfig
from .jmvae_model import JMVAE

__all__ = ["JMVAE", "JMVAEConfig"]
