from .auto_config import AutoConfig
from .auto_model import AutoModel

__all__ = ["AutoConfig", "AutoModel"]
