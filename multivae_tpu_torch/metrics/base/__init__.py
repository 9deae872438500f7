from .evaluator_class import Evaluator
from .evaluator_config import EvaluatorConfig
from .subset_sweep import all_subsets

__all__ = ["Evaluator", "EvaluatorConfig", "all_subsets"]
