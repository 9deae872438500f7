from .visualization_class import Visualization
from .visualize_config import VisualizationConfig

__all__ = ["Visualization", "VisualizationConfig"]
