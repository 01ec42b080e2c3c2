from cfgpp_tpu_torch.schedules.ddim import (
    DDIMSchedule,
    alphas_cumprod_table,
    leading_timesteps,
    make_ddim_schedule,
    scaled_linear_betas,
    trailing_timesteps,
)
from cfgpp_tpu_torch.schedules.karras import (
    append_zero,
    calculate_input_scale,
    get_ancestral_step,
    get_sigmas_karras,
    sigma_to_t_linear,
    timestep_log_nearest,
)

__all__ = [
    "DDIMSchedule",
    "alphas_cumprod_table",
    "leading_timesteps",
    "make_ddim_schedule",
    "scaled_linear_betas",
    "trailing_timesteps",
    "append_zero",
    "calculate_input_scale",
    "get_ancestral_step",
    "get_sigmas_karras",
    "sigma_to_t_linear",
    "timestep_log_nearest",
]
