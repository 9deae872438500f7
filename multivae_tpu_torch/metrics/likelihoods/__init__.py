from .likelihoods import LikelihoodsEvaluator
from .likelihoods_config import LikelihoodsEvaluatorConfig

__all__ = ["LikelihoodsEvaluator", "LikelihoodsEvaluatorConfig"]
