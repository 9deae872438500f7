from .joint_model import BaseJointModel
from .joint_model_config import BaseJointModelConfig

__all__ = ["BaseJointModel", "BaseJointModelConfig"]
