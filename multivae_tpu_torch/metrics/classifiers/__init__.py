from .mmnist import ClassifierPolyMNIST, load_mmnist_classifiers

__all__ = ["ClassifierPolyMNIST", "load_mmnist_classifiers"]
