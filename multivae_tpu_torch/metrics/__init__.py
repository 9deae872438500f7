"""Evaluation modules of the port (counterpart of
``multivae_tpu/metrics/``): the joint NLL, cross and joint coherences,
reconstruction SSIM / MSE, latent clustering, sample grids and FIDs. Each
sweeps its conditioning subsets one at a time on the model's device."""

from .base import Evaluator, EvaluatorConfig
from .classifiers import ClassifierPolyMNIST, load_mmnist_classifiers
from .coherences import CoherenceEvaluator, CoherenceEvaluatorConfig
from .fids import AdaptShapeFID, FIDEvaluator, FIDEvaluatorConfig, InceptionV3FID
from .latent_clustering import Clustering, ClusteringConfig
from .likelihoods import LikelihoodsEvaluator, LikelihoodsEvaluatorConfig
from .reconstruction import Reconstruction, ReconstructionConfig
from .visualization import Visualization, VisualizationConfig

__all__ = [
    "AdaptShapeFID",
    "ClassifierPolyMNIST",
    "Clustering",
    "ClusteringConfig",
    "CoherenceEvaluator",
    "CoherenceEvaluatorConfig",
    "Evaluator",
    "EvaluatorConfig",
    "FIDEvaluator",
    "FIDEvaluatorConfig",
    "InceptionV3FID",
    "LikelihoodsEvaluator",
    "LikelihoodsEvaluatorConfig",
    "Reconstruction",
    "ReconstructionConfig",
    "Visualization",
    "VisualizationConfig",
    "load_mmnist_classifiers",
]
