from .telbo_config import TELBOConfig
from .telbo_model import TELBO

__all__ = ["TELBO", "TELBOConfig"]
