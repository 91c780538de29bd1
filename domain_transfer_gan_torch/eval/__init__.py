"""Evaluation of the port: ``eval_mse_A``, the variational UBO
(``variational_ubo`` / ``eval_ubo_B``), the evaluation CLI's metrics
(``train_logvar``, the MVGauss baseline, noise sensitivity, the train KL,
proxy-FID, z-diversity), the extractor-free distribution distances
(``moments.py``) and the PNG image grids."""

from .diversity import eval_z_diversity, z_diversity_stats
from .fid import compute_fid, eval_fid_B, frechet_distance, \
    random_feature_extractor
from .metrics import (
    compute_bpp_mvgauss_B,
    compute_train_kld,
    eval_bpp_mvgauss_B,
    eval_mse_A,
    eval_ubo_B,
    sensitivity_to_edge_noise,
    train_logvar,
    train_mvgauss_B,
    variational_ubo,
)
from .moments import (
    channel_moment_distance,
    distribution_distances,
    radial_spectrum_distance,
)
from .visualize import one_to_three_channels, save_image_grid, visualize_data

__all__ = ["eval_mse_A", "eval_ubo_B", "variational_ubo", "train_logvar",
           "train_mvgauss_B", "eval_bpp_mvgauss_B", "compute_bpp_mvgauss_B",
           "sensitivity_to_edge_noise", "compute_train_kld", "compute_fid",
           "eval_fid_B", "frechet_distance", "random_feature_extractor",
           "eval_z_diversity", "z_diversity_stats",
           "channel_moment_distance", "radial_spectrum_distance",
           "distribution_distances",
           "one_to_three_channels", "save_image_grid", "visualize_data"]
