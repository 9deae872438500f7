from .jnf_config import JNFConfig
from .jnf_model import JNF

__all__ = ["JNF", "JNFConfig"]
