from .base_ae_model import BaseMultiVAE
from .base_config import BaseMultiVAEConfig
from .base_model import BaseModel
from .step import StepInfo

__all__ = ["BaseModel", "BaseMultiVAE", "BaseMultiVAEConfig", "StepInfo"]
