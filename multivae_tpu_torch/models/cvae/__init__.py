from .cvae_config import CVAEConfig
from .cvae_model import CVAE

__all__ = ["CVAE", "CVAEConfig"]
