"""The diffusion processes and their schedules (``founddiff_tpu/diffusion``)."""

from founddiff_tpu_torch.diffusion.schedules import (
    GaussianSchedule,
    ResidualSchedule,
    betas_for_alpha_bar,
    ddim_time_pairs,
    extract,
    gen_coefficients,
    make_beta_schedule,
    make_gaussian_schedule,
    make_residual_schedule,
)
from founddiff_tpu_torch.diffusion.residual import (
    ModelResPrediction,
    ResidualDiffusion,
    normalize_to_neg_one_to_one,
    unnormalize_to_zero_to_one,
)
from founddiff_tpu_torch.diffusion.gaussian import GaussianDiffusion

__all__ = [
    "GaussianDiffusion",
    "GaussianSchedule",
    "ModelResPrediction",
    "ResidualDiffusion",
    "ResidualSchedule",
    "betas_for_alpha_bar",
    "ddim_time_pairs",
    "extract",
    "gen_coefficients",
    "make_beta_schedule",
    "make_gaussian_schedule",
    "make_residual_schedule",
    "normalize_to_neg_one_to_one",
    "unnormalize_to_zero_to_one",
]
