from .dreg import scale_grad
from .kdist import (
    dist_log_prob,
    dist_rsample,
    dist_rsample_k,
    log_var_to_std,
    mixture_logsumexp,
    sample_noise,
)
from .mixture import mixture_log_density, mixture_log_density_plain

__all__ = [
    "dist_log_prob",
    "dist_rsample",
    "dist_rsample_k",
    "log_var_to_std",
    "mixture_log_density",
    "mixture_log_density_plain",
    "mixture_logsumexp",
    "sample_noise",
    "scale_grad",
]
