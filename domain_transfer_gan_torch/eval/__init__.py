"""Evaluation of the port: ``eval_mse_A``, the variational UBO
(``variational_ubo`` / ``eval_ubo_B``) and the PNG image grids.  The test
CLI's other metrics (MVGauss baseline, noise sensitivity, FID, z-diversity,
moments) are not ported yet."""

from .metrics import eval_mse_A, eval_ubo_B, variational_ubo
from .visualize import one_to_three_channels, save_image_grid, visualize_data

__all__ = ["eval_mse_A", "eval_ubo_B", "variational_ubo",
           "one_to_three_channels", "save_image_grid", "visualize_data"]
