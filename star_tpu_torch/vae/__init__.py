from .svd_vae import SVD_VAE_SCALING, SVDTemporalVAE
