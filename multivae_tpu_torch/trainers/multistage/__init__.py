from .multistage_trainer import MultistageTrainer
from .multistage_trainer_config import MultistageTrainerConfig

__all__ = ["MultistageTrainer", "MultistageTrainerConfig"]
