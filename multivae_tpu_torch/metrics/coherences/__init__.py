from .coherences import CoherenceEvaluator
from .coherences_config import CoherenceEvaluatorConfig

__all__ = ["CoherenceEvaluator", "CoherenceEvaluatorConfig"]
