from .nexus_config import NexusConfig
from .nexus_model import Nexus

__all__ = ["Nexus", "NexusConfig"]
