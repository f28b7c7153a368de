from .svd_vae import SVD_VAE_SCALING, SVDTemporalVAE
from .causal_vae import COGVIDEO_VAE_SCALING, CogVideoVAE
