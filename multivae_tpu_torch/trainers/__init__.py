from .base import BaseTrainer, BaseTrainerConfig
from .multistage import MultistageTrainer, MultistageTrainerConfig

__all__ = ["BaseTrainer", "BaseTrainerConfig", "MultistageTrainer",
           "MultistageTrainerConfig"]
