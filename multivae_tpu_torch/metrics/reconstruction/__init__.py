from .reconstruction import Reconstruction
from .reconstruction_config import ReconstructionConfig

__all__ = ["Reconstruction", "ReconstructionConfig"]
