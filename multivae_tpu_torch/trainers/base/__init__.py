from .base_trainer import BaseTrainer
from .base_trainer_config import BaseTrainerConfig

__all__ = ["BaseTrainer", "BaseTrainerConfig"]
