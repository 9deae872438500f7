from .fids import AdaptShapeFID, FIDEvaluator
from .fids_config import FIDEvaluatorConfig
from .inception_networks import InceptionV3FID, wrapper_inception

__all__ = ["AdaptShapeFID", "FIDEvaluator", "FIDEvaluatorConfig", "InceptionV3FID",
           "wrapper_inception"]
