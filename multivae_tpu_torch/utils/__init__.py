from .device import resolve_device
from .model_output import ModelOutput

__all__ = ["ModelOutput", "resolve_device"]
