from .clustering_class import Clustering
from .clustering_config import ClusteringConfig

__all__ = ["Clustering", "ClusteringConfig"]
