"""Plain float32 reference of STAR's I2VGen-XL video super-resolution
(NJU-PCALab/STAR, video_to_video_model.py and diffusion_sdedit.py):
x4 bilinear upsample and pad to the UNet grid, VAE encode (a posterior
sample), SDEdit diffuse to t = 899, DPM++(2M)-SDE over the CFG pair of
UNet + ControlNet on the trailing fast 4+11 ladder, windowed temporal VAE
decode, AdaIN colour fix.

The schedule arithmetic is host float64 numpy; the model math is
i2vgen.py's. The noise is an input: `noise` holds the posterior's eps,
the diffuse draw and one draw per SDE step.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import i2vgen
from .prims import Precision, Weights

SVD_VAE_SCALING = 0.18215


# -------------------------------------------------------------- schedule
def star_sigmas(n: int = 1000) -> np.ndarray:
    """logsnr-cosine-interp (scales 2 and 4) with the zero-terminal-SNR
    rescale: the VP sigmas of STAR's I2VGen-XL path."""
    t = np.linspace(1.0, 0.0, n)

    def cosine(scale):
        t_min = math.atan(math.exp(7.5))
        t_max = math.atan(math.exp(-7.5))
        return (-2.0 * np.log(np.tan(t_min + t * (t_max - t_min)))
                + 2.0 * math.log(1.0 / scale))

    logsnr = t * cosine(2.0) + (1.0 - t) * cosine(4.0)
    sig = np.sqrt(1.0 / (1.0 + np.exp(logsnr)))
    scale = (1.0 - sig.min()) / (sig.max() - sig.min())
    return sig.min() + scale * (sig - sig.min())


def _log_sigmas_edm(sig: np.ndarray) -> np.ndarray:
    with np.errstate(divide='ignore'):
        return np.log(np.sqrt(sig ** 2 / (1.0 - sig ** 2)))


def sigma_ladder(sig: np.ndarray, steps: int, t_max: int) -> np.ndarray:
    """The trailing fast ladder (4 steps from t_max down to 500, 11 from
    500 to 0, one more than `steps`), as EDM sigmas, a terminal 0 appended
    and the penultimate sigma discarded."""
    assert steps == 15, 'the fast ladder has 4 + 11 steps'
    s1 = np.arange(t_max, 499, -((t_max - 500 + 1) / 4.0))
    s2 = np.arange(500, -1, -((500 + 1) / 11.0))
    ts = np.clip(np.concatenate([s1, s2]), 0, t_max)
    logs = _log_sigmas_edm(sig)
    lo, hi = np.floor(ts).astype(np.int64), np.ceil(ts).astype(np.int64)
    wgt = ts - lo
    with np.errstate(invalid='ignore'):
        ls = (1.0 - wgt) * logs[lo] + wgt * logs[hi]
    sigmas = np.exp(np.where(np.isfinite(ls), ls, np.inf))
    sigmas = np.concatenate([sigmas, [0.0]])
    return np.concatenate([sigmas[:-2], sigmas[-1:]])


def sigma_to_t(sig: np.ndarray, sigma: float) -> float:
    logs = _log_sigmas_edm(sig)
    ls = math.log(sigma)
    low = int(np.argmax(np.cumsum((ls - logs) >= 0)))
    low = min(low, len(logs) - 2)
    a, b = logs[low], logs[low + 1]
    w = float(np.clip((a - ls) / (a - b), 0.0, 1.0))
    return (1.0 - w) * low + w * (low + 1)


# --------------------------------------------------------------- helpers
def pad_to_grid(h: int, w: int, grid: tuple[int, int]):
    """(w1, w2, h1, h2): centred padding onto a grid at least as large."""
    gh, gw = grid
    assert h <= gh and w <= gw, 'only clips that fit the grid'
    h1, w1 = (gh - h) // 2, (gw - w) // 2
    return w1, gw - w - w1, h1, gh - h - h1


def bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """[F, H, W, C] -> [F, out_h, out_w, C], half-pixel centres,
    antialiased where an axis shrinks, computed in float64."""
    y = F.interpolate(x.permute(0, 3, 1, 2).double(), size=(out_h, out_w),
                      mode='bilinear', align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1).float()


def adain(target: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
    """target [F, H, W, 3] in 0..255, source [F, h, w, 3] in [-1, 1] ->
    target with the source's per-frame, per-channel mean and std (ddof 1),
    clamped, in 0..255."""
    def stats(x):
        flat = x.reshape(x.shape[0], -1, x.shape[-1])
        return (flat.mean(1)[:, None, None],
                torch.sqrt(flat.var(1, unbiased=True) + 1e-5)[:, None, None])
    t = target / 255.0
    s = (source + 1.0) / 2.0
    tm, ts = stats(t)
    sm, ss = stats(s)
    return torch.clamp((t - tm) / ts * ss + sm, 0.0, 1.0) * 255.0


def cfg_x0(alpha, sigma, xt, v, guide_scale, guide_rescale):
    v_c, v_u = v.chunk(2)
    out = v_u + guide_scale * (v_c - v_u)
    ratio = v_c.reshape(1, -1).std(1) / (out.reshape(1, -1).std(1) + 1e-12)
    out = out * (guide_rescale * ratio + (1.0 - guide_rescale))
    return alpha * xt - sigma * out


# -------------------------------------------------------------- pipeline
def enhance(p: Precision, sd: dict, cfg: dict, frames: torch.Tensor,
            tokens_cond: torch.Tensor, tokens_uncond: torch.Tensor,
            noise: dict, text_cache: dict | None = None) -> torch.Tensor:
    """frames [F, H, W, 3] uint8 on the device -> the enhanced clip
    [F, 4H, 4W, 3] in 0..255 (float32, before rounding).

    sd: the state dict (program names, float32) of 'unet.', 'vae.' and
    'text.' towers; cfg: the configuration file's dict."""
    arch, vae, clip = cfg['unet'], cfg['vae'], cfg['text']
    pipe, smp = cfg['pipeline'], cfg['sampler']
    f, h, w, _ = frames.shape
    th, tw = h * pipe['upscale'], w * pipe['upscale']
    video = (frames.float() / 255.0 - 0.5) / 0.5

    tw_ = Weights(sd, 'text.')
    blocks = i2vgen.n_clip_blocks(clip['layers'], clip['penultimate'])
    y_c = i2vgen.clip_text(p, tw_, tokens_cond, clip['heads'], blocks)
    y_u = i2vgen.clip_text(p, tw_, tokens_uncond, clip['heads'], blocks)
    y = torch.cat([y_c, y_u])

    w1, w2, h1, h2 = pad_to_grid(th, tw, tuple(pipe['pad_grid']))
    up = bilinear(video, th, tw)
    padded = F.pad(up, (0, 0, w1, w2, h1, h2), value=pipe['pad_value'])
    vw = Weights(sd, 'vae.encoder.')
    levels = len(vae['block_out_channels'])
    moments = torch.cat([
        i2vgen.vae_encode_moments(p, vw, padded[i:i + 1], levels,
                                  vae['encoder_layers'])
        for i in range(f)])[None]
    mean, logvar = moments.chunk(2, dim=-1)
    std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0))
    z_lq = (mean + std * noise['enc_eps']) * SVD_VAE_SCALING

    sig = star_sigmas()
    alphas = np.sqrt(1.0 - sig ** 2)
    tab_s = torch.tensor(sig, dtype=torch.float32, device=frames.device)
    tab_a = torch.tensor(alphas, dtype=torch.float32, device=frames.device)
    t_init = smp['total_noise_levels'] - 1
    x_init = tab_a[t_init] * z_lq + tab_s[t_init] * noise['diffuse']

    uw = Weights(sd, 'unet.')

    def x0_fn(xt, t: int):
        tt = torch.full((1,), t, dtype=torch.long, device=xt.device)
        v = i2vgen.controlled_unet(p, uw, arch, xt, tt, y, z_lq)
        return cfg_x0(tab_a[t], tab_s[t], xt, v, smp['guide_scale'],
                      smp['guide_rescale'])

    sigmas = sigma_ladder(sig, smp['steps'], t_init)
    ts = [0 if s == 0.0 else int(round(sigma_to_t(sig, float(s))))
          for s in sigmas]
    c_in = lambda s: 1.0 / float(np.sqrt(s * s + 1.0))
    n = len(sigmas) - 1
    x = x_init * float(sigmas[0])
    old, h_last = None, None
    for i in range(n - 1):
        s0, s1 = float(sigmas[i]), float(sigmas[i + 1])
        den = x0_fn(x * c_in(s0), ts[i])
        hh = math.log(s0) - math.log(s1)
        phi = -math.expm1(-2.0 * hh)
        x = (s1 / s0) * math.exp(-hh) * x + phi * den
        if old is not None:
            x = x + 0.5 * phi * (h_last / hh) ** -1 * (den - old)
        x = x + noise['sde'][i] * (s1 * math.sqrt(-math.expm1(-2.0 * hh)))
        old, h_last = den, hh
    gen = x0_fn(x * c_in(float(sigmas[n - 1])), ts[n - 1])

    dw = Weights(sd, 'vae.decoder.')
    z = gen / SVD_VAE_SCALING
    win = pipe['vae_decode_window']
    out = torch.cat([
        i2vgen.vae_decode_window(p, dw, z[:, s:s + win], levels,
                                 vae['decoder_layers'])
        for s in range(0, f, win)], dim=1)[0]
    out = out[:, h1:h1 + th, w1:w1 + tw]
    out = torch.clamp(out * 0.5 + 0.5, 0.0, 1.0) * 255.0
    return adain(out, video)


def sde_steps(steps: int = 15) -> int:
    """Noise draws of the sampler: one per step but the last (14 model
    calls on the fast ladder, 13 draws)."""
    return len(sigma_ladder(star_sigmas(), steps, 899)) - 2
