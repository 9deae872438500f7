from .base import BaseTrainer, BaseTrainerConfig

__all__ = ["BaseTrainer", "BaseTrainerConfig"]
