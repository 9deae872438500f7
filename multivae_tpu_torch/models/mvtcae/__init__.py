from .mvtcae_config import MVTCAEConfig
from .mvtcae_model import MVTCAE

__all__ = ["MVTCAE", "MVTCAEConfig"]
