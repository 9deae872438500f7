from .crmvae_config import CRMVAEConfig
from .crmvae_model import CRMVAE

__all__ = ["CRMVAE", "CRMVAEConfig"]
