from .dreg import scale_grad
from .gaussian import (
    gaussian_log_prob,
    kl_divergence,
    masked_poe,
    poe,
    rsample_from_gaussian,
    stable_poe,
)
from .iwae import chunked_logsumexp, iwae_log_marginal
from .kdist import (
    dist_log_prob,
    dist_rsample,
    dist_rsample_k,
    log_var_to_std,
    mixture_logsumexp,
    sample_noise,
)
from .mixture import mixture_log_density, mixture_log_density_plain
from .subsets import all_subsets, all_subsets_mask, subsets_to_mask

__all__ = [
    "all_subsets",
    "all_subsets_mask",
    "chunked_logsumexp",
    "dist_log_prob",
    "dist_rsample",
    "dist_rsample_k",
    "gaussian_log_prob",
    "iwae_log_marginal",
    "kl_divergence",
    "log_var_to_std",
    "masked_poe",
    "mixture_log_density",
    "mixture_log_density_plain",
    "mixture_logsumexp",
    "poe",
    "rsample_from_gaussian",
    "sample_noise",
    "scale_grad",
    "stable_poe",
    "subsets_to_mask",
]
