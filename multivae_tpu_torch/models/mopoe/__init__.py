from .mopoe_config import MoPoEConfig
from .mopoe_model import MoPoE

__all__ = ["MoPoE", "MoPoEConfig"]
