from .schedules import (Schedule, noise_schedule, default_star_schedule,
                        karras_schedule, build_sigma_ladder,
                        trailing_timesteps, t_to_sigma, sigma_to_t)
from .gaussian import (DiffusionTables, diffuse, denoise_to_x0, get_velocity,
                       get_x0, guide_rescale_combine)
from .solvers import sample_dpmpp_2m_sde, sample_heun
from .zero_snr import (EDMDiscretization, LegacyDDPMDiscretization,
                       ZeroSNRDDPMDiscretization, dynamic_cfg_scale,
                       video_scaling)
from .vpsde_sampler import (sample_vpode_dpmpp_2m, sample_vpsde_dpmpp_2m,
                            vpsde_dpmpp_2m_ladder)
