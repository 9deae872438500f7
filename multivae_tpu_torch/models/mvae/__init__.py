from .mvae_config import MVAEConfig
from .mvae_model import MVAE

__all__ = ["MVAE", "MVAEConfig"]
