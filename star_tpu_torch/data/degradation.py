"""RealESRGAN-style two-stage video degradation for paired-data generation
(counterpart of star_tpu/data/degradation.py), batched over frames on the
device.

Behavioral reference: utils_data/opensora/datasets/high_order/degrade_video.py
(Degradation:79-497) and its kernel/noise/jpeg helpers: USM sharpen ->
[blur -> random resize -> gaussian|poisson noise -> DiffJPEG -> codec] x2 ->
final sinc; recipe='mid' is degrade_video_mid.py (stage 1 resizes toward
the final LR size) and use_codec=False the codec-free image recipe of
RealESRGAN_Deg_pipeline.py.

The split is the JAX package's:
  * the per-clip random parameters are drawn on the host, with the same
    np.random.RandomState and random.Random calls, so the kernels, scales
    and qualities are those of the JAX package bit for bit;
  * the per-frame math (depthwise blur with reflect padding, resize,
    noise, the DCT JPEG round trip, the codec proxy) runs as PyTorch ops
    on the device of the frames, all frames at once; there is no TPU
    kernel behind it (the JAX package jits a jnp graph);
  * the H.264/mpeg4 re-encode runs through PyAV when it imports, else
    through the device-side codec_proxy, as in the JAX package.

`_resize` computes what jax.image.resize computes: for 'bicubic' and
'bilinear' separable weight matrices of the Keys cubic (a = -0.5) or
triangle kernel at half-pixel centres, renormalised at the borders
(F.interpolate's bicubic, a = -0.75 with clamped borders, is another
function); for 'area', the antialiased linear resize, the port's
ops.resize.resize_bilinear. The noises draw from a torch.Generator;
their draws can be injected (the JAX package draws from threefry keys,
which Philox cannot reproduce), and degrade_video takes a `draw` callable
for that.
"""

from __future__ import annotations

import dataclasses
import io
import math
import random
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.resize import resize_bilinear
from ..utils.device import resolve_device
from ..utils.logger import get_logger

logger = get_logger()

KERNEL_SIZE = 21


# --------------------------------------------------------------------------
# blur kernels (host numpy; formulas per the RealESRGAN degradation family)
# --------------------------------------------------------------------------

def _mesh(ks: int):
    ax = np.arange(ks) - ks // 2
    xx, yy = np.meshgrid(ax, ax)
    return np.stack([xx, yy], -1).astype(np.float64)  # [ks,ks,2]


def _sigma_matrix(sig_x: float, sig_y: float, theta: float) -> np.ndarray:
    d = np.diag([sig_x**2, sig_y**2])
    u = np.array([[np.cos(theta), -np.sin(theta)],
                  [np.sin(theta), np.cos(theta)]])
    return u @ d @ u.T


def bivariate_gaussian(ks: int, sig_x: float, sig_y: float, theta: float,
                       isotropic: bool = True) -> np.ndarray:
    grid = _mesh(ks)
    if isotropic:
        sigma = np.eye(2) * sig_x**2
    else:
        sigma = _sigma_matrix(sig_x, sig_y, theta)
    inv = np.linalg.inv(sigma)
    z = np.einsum('hwi,ij,hwj->hw', grid, inv, grid)
    k = np.exp(-0.5 * z)
    return k / k.sum()


def bivariate_generalized_gaussian(ks: int, sig_x: float, sig_y: float,
                                   theta: float, beta: float,
                                   isotropic: bool = True) -> np.ndarray:
    grid = _mesh(ks)
    sigma = (np.eye(2) * sig_x**2 if isotropic
             else _sigma_matrix(sig_x, sig_y, theta))
    inv = np.linalg.inv(sigma)
    z = np.einsum('hwi,ij,hwj->hw', grid, inv, grid)
    k = np.exp(-0.5 * np.power(z, beta))
    return k / k.sum()


def bivariate_plateau(ks: int, sig_x: float, sig_y: float, theta: float,
                      beta: float, isotropic: bool = True) -> np.ndarray:
    grid = _mesh(ks)
    sigma = (np.eye(2) * sig_x**2 if isotropic
             else _sigma_matrix(sig_x, sig_y, theta))
    inv = np.linalg.inv(sigma)
    z = np.einsum('hwi,ij,hwj->hw', grid, inv, grid)
    k = 1.0 / (np.power(z, beta) + 1.0)
    return k / k.sum()


def circular_lowpass_kernel(omega_c: float, ks: int,
                            pad_to: int = 0) -> np.ndarray:
    """2D sinc filter (ideal circular lowpass, jinc form)."""
    from scipy import special
    assert ks % 2 == 1
    ax = np.arange(ks) - (ks - 1) / 2
    xx, yy = np.meshgrid(ax, ax)
    r = np.sqrt(xx**2 + yy**2)
    with np.errstate(divide='ignore', invalid='ignore'):
        kernel = omega_c * special.j1(omega_c * r) / (2 * np.pi * r)
    kernel[(ks - 1) // 2, (ks - 1) // 2] = omega_c**2 / (4 * np.pi)
    kernel = kernel / kernel.sum()
    if pad_to > ks:
        p = (pad_to - ks) // 2
        kernel = np.pad(kernel, ((p, p), (p, p)))
    return kernel


def random_mixed_kernel(rng: np.random.RandomState, kernel_list, kernel_prob,
                        ks: int, sigma_range, rot_range, betag_range,
                        betap_range) -> np.ndarray:
    kind = rng.choice(kernel_list, p=kernel_prob)
    sx = rng.uniform(*sigma_range)
    sy = rng.uniform(*sigma_range)
    theta = rng.uniform(*rot_range)
    if kind == 'iso':
        return bivariate_gaussian(ks, sx, sy, theta, True)
    if kind == 'aniso':
        return bivariate_gaussian(ks, sx, sy, theta, False)
    if kind == 'generalized_iso':
        return bivariate_generalized_gaussian(ks, sx, sy, theta,
                                              rng.uniform(*betag_range), True)
    if kind == 'generalized_aniso':
        return bivariate_generalized_gaussian(ks, sx, sy, theta,
                                              rng.uniform(*betag_range), False)
    if kind == 'plateau_iso':
        return bivariate_plateau(ks, sx, sy, theta,
                                 rng.uniform(*betap_range), True)
    return bivariate_plateau(ks, sx, sy, theta, rng.uniform(*betap_range),
                             False)


# --------------------------------------------------------------------------
# per-clip random parameter sampling (mirrors Degradation.__init__ ranges)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class StageParams:
    kernel: np.ndarray          # [21,21]
    apply_blur: bool
    resize_scale: float
    resize_mode: str
    use_gaussian_noise: bool
    noise_sigma: float          # gaussian sigma (0-255 scale)
    poisson_scale: float
    gray_noise: bool
    jpeg_quality: float


@dataclasses.dataclass
class DegradationParams:
    stage1: StageParams
    stage2: StageParams
    sinc_kernel: np.ndarray
    sinc_before_jpeg: bool      # order of [resize back+sinc] vs jpeg in stage 2


def _quantize_scale(s: float) -> float:
    return max(round(s * 16) / 16.0, 1.0 / 16)


def _sample_kernel(rng, sinc_prob, sigma_range, betag, betap) -> np.ndarray:
    ks = int(rng.choice([2 * v + 1 for v in range(3, 11)]))
    if rng.uniform() < sinc_prob:
        omega = (rng.uniform(np.pi / 3, np.pi) if ks < 13
                 else rng.uniform(np.pi / 5, np.pi))
        k = circular_lowpass_kernel(omega, ks)
    else:
        k = random_mixed_kernel(
            rng,
            ['iso', 'aniso', 'generalized_iso', 'generalized_aniso',
             'plateau_iso', 'plateau_aniso'],
            [0.45, 0.25, 0.12, 0.03, 0.12, 0.03], ks, sigma_range,
            (-math.pi, math.pi), betag, betap)
    pad = (KERNEL_SIZE - ks) // 2
    return np.pad(k, ((pad, pad), (pad, pad))).astype(np.float32)


def _sample_stage(rng, *, sigma_range, sinc_prob, resize_prob, resize_range,
                  gauss_prob, noise_range, poisson_range, gray_prob,
                  jpeg_range, blur_prob=1.0) -> StageParams:
    kernel = _sample_kernel(rng, sinc_prob, sigma_range, (0.5, 4), (1, 2))
    updown = rng.choice(['up', 'down', 'keep'], p=resize_prob)
    if updown == 'up':
        scale = rng.uniform(1, resize_range[1])
    elif updown == 'down':
        scale = rng.uniform(resize_range[0], 1)
    else:
        scale = 1.0
    return StageParams(
        kernel=kernel,
        apply_blur=rng.uniform() < blur_prob,
        resize_scale=_quantize_scale(scale),
        resize_mode=rng.choice(['area', 'bilinear', 'bicubic']),
        use_gaussian_noise=rng.uniform() < gauss_prob,
        noise_sigma=float(rng.uniform(*noise_range)),
        poisson_scale=float(rng.uniform(*poisson_range)),
        gray_noise=rng.uniform() < gray_prob,
        jpeg_quality=float(rng.uniform(*jpeg_range)),
    )


def sample_degradation_params(seed: int,
                              recipe: str = 'default') -> DegradationParams:
    """recipe 'default' = degrade_video.py; 'mid' = degrade_video_mid.py
    (identical ranges, but stage 1 resizes toward the FINAL LR size with the
    stage-2 resize distribution instead of a free scale of the original —
    the only substantive diff between the two reference files)."""
    rng = np.random.RandomState(seed)
    s1_resize = (dict(resize_prob=[0.2, 0.7, 0.1], resize_range=(0.15, 1.5))
                 if recipe == 'default' else
                 dict(resize_prob=[0.3, 0.4, 0.3], resize_range=(0.3, 1.2)))
    s1 = _sample_stage(rng, sigma_range=(0.2, 3), sinc_prob=0.1,
                       gauss_prob=0.5, noise_range=(1, 30),
                       poisson_range=(0.05, 3), gray_prob=0.4,
                       jpeg_range=(30, 95), **s1_resize)
    s2 = _sample_stage(rng, sigma_range=(0.2, 1.5), sinc_prob=0.1,
                       resize_prob=[0.3, 0.4, 0.3], resize_range=(0.3, 1.2),
                       gauss_prob=0.5, noise_range=(1, 25),
                       poisson_range=(0.05, 2.5), gray_prob=0.4,
                       jpeg_range=(30, 95), blur_prob=0.8)
    if rng.uniform() < 0.8:  # final_sinc_prob
        ks = int(rng.choice([2 * v + 1 for v in range(3, 11)]))
        omega = rng.uniform(np.pi / 3, np.pi)
        sinc = circular_lowpass_kernel(omega, ks, pad_to=KERNEL_SIZE)
    else:
        sinc = np.zeros((KERNEL_SIZE, KERNEL_SIZE), np.float32)
        sinc[KERNEL_SIZE // 2, KERNEL_SIZE // 2] = 1.0  # pulse
    return DegradationParams(s1, s2, sinc.astype(np.float32),
                             sinc_before_jpeg=rng.uniform() < 0.5)




# --------------------------------------------------------------------------
# device math (batched over frames; x is [F, H, W, 3] fp32 in [0, 1])
# --------------------------------------------------------------------------

def _reflect_index(n: int, pad: int, device) -> torch.Tensor:
    """Source positions of numpy's 'reflect' padding of a length-n axis by
    `pad` on both sides, for any pad (reflecting as often as it takes, as
    jnp.pad does; F.pad's reflect takes pad < n only)."""
    i = torch.arange(-pad, n + pad, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = i.remainder(period)
    return torch.where(i >= n, period - i, i)


def _pad_hw(x: torch.Tensor, pad: int, mode: str, to_h: int = 0,
            to_w: int = 0) -> torch.Tensor:
    """x [F, H, W, C] padded on H and W: 'reflect' by `pad` on both sides,
    or 'edge' at the end up to (to_h, to_w)."""
    _, h, w, _ = x.shape
    if mode == 'reflect':
        ih, iw = (_reflect_index(n, pad, x.device) for n in (h, w))
    else:
        ih = torch.arange(to_h, device=x.device).clamp_max(h - 1)
        iw = torch.arange(to_w, device=x.device).clamp_max(w - 1)
    return x.index_select(1, ih).index_select(2, iw)


def _conv_valid(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise VALID cross-correlation of x [F, H, W, C] with a 2-D
    kernel [kh, kw] shared by the channels, in fp32 (TF32 off)."""
    c = x.shape[-1]
    k = kernel.to(x.device, torch.float32)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y = F.conv2d(x.permute(0, 3, 1, 2), k[None, None].expand(c, 1,
                                                                 *k.shape),
                     groups=c)
    return y.permute(0, 2, 3, 1)


def filter2d(x: torch.Tensor, kernel) -> torch.Tensor:
    """Depthwise 2D filter with reflect padding (utils_.py filter2D)."""
    kernel = torch.as_tensor(kernel, dtype=torch.float32)
    return _conv_valid(_pad_hw(x, kernel.shape[-1] // 2, 'reflect'), kernel)


def usm_sharpen(x: torch.Tensor, weight: float = 0.5, radius: int = 25,
                threshold: float = 10.0) -> torch.Tensor:
    """Unsharp masking (utils_.py USMSharp: gaussian blur radius 50->sigma,
    residual mask threshold 10/255). The 51x51 Gaussian is the outer
    product of one row, so it runs as a column then a row filter on the
    reflect-padded frames: the same sums as the 2-D filter, in another
    order, for 2 x 51 taps a pixel instead of 51^2."""
    ax = np.arange(2 * radius + 1) - radius
    g = np.exp(-(ax**2) / (2 * (radius / 3.0) ** 2))
    g = torch.from_numpy((g / g.sum()).astype(np.float32))

    def blur(t):
        tp = _pad_hw(t, radius, 'reflect')
        return _conv_valid(_conv_valid(tp, g[:, None]), g[None, :])
    residual = x - blur(x)
    mask = (torch.abs(residual) * 255.0 > threshold).float()
    soft_mask = blur(mask)
    sharp = torch.clamp(x + weight * residual, 0.0, 1.0)
    return soft_mask * sharp + (1.0 - soft_mask) * x


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic kernel with a = -0.5 (jax.image's 'cubic')."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x))


def resize_weights(n_in: int, n_out: int, method: str) -> np.ndarray:
    """[n_in, n_out] fp32 weights of jax.image.resize(..., antialias=False)
    along one axis (jax._src.image.scale.compute_weight_mat, computed in
    fp32 as there): half-pixel centres, each column renormalised to sum to
    one."""
    kernel = {'cubic': _keys_cubic, 'linear': _triangle}[method]
    f32 = np.float32
    inv_scale = f32(1.0) / (f32(n_out) / f32(n_in))
    sample_f = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale \
        - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None])
    w = kernel(x).astype(f32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(f32)


def resize_jax(x: torch.Tensor, out_h: int, out_w: int,
               method: str) -> torch.Tensor:
    """jax.image.resize(x, (..., out_h, out_w, C), method, antialias=False)
    of x [..., H, W, C] fp32, method 'cubic' or 'linear': each axis whose
    size changes is multiplied by its weight matrix (an axis that keeps its
    size is left as it is, as there). On an axis that grows antialiasing
    changes nothing, so an upsample is also jax.image.resize's default."""
    h, w = x.shape[-3], x.shape[-2]
    mats = {}
    if out_h != h:
        mats['h'] = resize_weights(h, out_h, method)
    if out_w != w:
        mats['w'] = resize_weights(w, out_w, method)
    to = lambda a: torch.from_numpy(a).to(x.device)
    if 'h' in mats:
        x = torch.einsum('...hwc,hk->...kwc', x, to(mats['h']))
    if 'w' in mats:
        x = torch.einsum('...hwc,wk->...hkc', x, to(mats['w']))
    return x


def _resize(x: torch.Tensor, out_h: int, out_w: int,
            mode: str) -> torch.Tensor:
    if mode == 'bicubic':
        return resize_jax(x, out_h, out_w, 'cubic')
    if mode == 'bilinear':
        return resize_jax(x, out_h, out_w, 'linear')
    # 'area' ~ antialiased linear downsample
    return resize_bilinear(x, out_h, out_w)


def add_gaussian_noise(x: torch.Tensor, sigma: float, gray: bool,
                       normal: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
    """x + N(0, sigma/255), one draw for all channels when `gray`. The
    standard normals are `normal` ([F, H, W, 1] gray, else x's shape) or
    drawn from `generator`."""
    f, h, w, _ = x.shape
    if normal is None:
        normal = torch.randn((f, h, w, 1) if gray else x.shape,
                             generator=generator, device=x.device)
    n = normal.to(x.device, torch.float32).expand(x.shape)
    return torch.clamp(x + n * (sigma / 255.0), 0.0, 1.0)


def add_poisson_noise(x: torch.Tensor, scale: float, gray: bool,
                      counts=None,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
    """Poisson noise at 1024 levels (the JAX package's fixed level count),
    on the channel mean when `gray`. The counts are `counts` (a tensor, or
    a callable of the rate tensor) or drawn from `generator`."""
    img = torch.mean(x, dim=-1, keepdim=True) if gray else x
    vals = 2.0 ** 10
    rate = img * vals
    if counts is None:
        # a cubic resize overshoots below 0; jax.random.poisson gives -1
        # at a negative rate, and so does this
        counts = torch.where(rate < 0, -1.0, torch.poisson(
            rate.clamp_min(0), generator=generator))
    elif callable(counts):
        counts = counts(rate)
    noisy = counts.to(x.device, torch.float32) / vals
    noise = ((noisy - img) * scale).expand(x.shape)
    return torch.clamp(x + noise, 0.0, 1.0)


# ---- DiffJPEG: 8x8 DCT quantization round-trip -----------------------------

_Y_TABLE = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99]], np.float32)

_C_TABLE = np.array([
    [17, 18, 24, 47, 99, 99, 99, 99],
    [18, 21, 26, 66, 99, 99, 99, 99],
    [24, 26, 56, 99, 99, 99, 99, 99],
    [47, 66, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99]], np.float32)


def _dct_matrix() -> np.ndarray:
    m = np.zeros((8, 8), np.float64)
    for k in range(8):
        for n in range(8):
            m[k, n] = np.cos(np.pi * k * (2 * n + 1) / 16) * \
                (np.sqrt(1 / 8) if k == 0 else np.sqrt(2 / 8))
    return m


_DCT = _dct_matrix().astype(np.float32)

_RGB2YCBCR = np.array([[0.299, 0.587, 0.114],
                       [-0.168736, -0.331264, 0.5],
                       [0.5, -0.418688, -0.081312]], np.float32)
_YCBCR2RGB = np.linalg.inv(_RGB2YCBCR.astype(np.float64)).astype(np.float32)


def _const(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(a).to(device)


def _quality_tables(scale: torch.Tensor) -> torch.Tensor:
    """[8, 8, 3] (Y, Cb, Cr) tables at the libjpeg quality scale
    (fp32 0-d tensor): floor((base * scale + 50) / 100), within [1, 255]."""
    dev = scale.device
    tab = lambda base: torch.clamp(torch.floor(
        (_const(base, dev) * scale + 50.0) / 100.0), 1, 255)
    ytab, ctab = tab(_Y_TABLE), tab(_C_TABLE)
    return torch.stack([ytab, ctab, ctab], dim=-1)


def _to_ycbcr(x01: torch.Tensor) -> torch.Tensor:
    ycc = torch.einsum('fhwc,dc->fhwd', x01 * 255.0,
                       _const(_RGB2YCBCR, x01.device))
    return ycc + _const(np.array([0.0, 128.0, 128.0], np.float32), x01.device)


def _to_rgb01(ycc: torch.Tensor, h: int, w: int) -> torch.Tensor:
    ycc = ycc - _const(np.array([0.0, 128.0, 128.0], np.float32), ycc.device)
    rgb = torch.einsum('fhwd,cd->fhwc', ycc,
                       _const(_YCBCR2RGB, ycc.device)) / 255.0
    return torch.clamp(rgb[:, :h, :w], 0.0, 1.0)


def _dct_quant(img: torch.Tensor, tab: torch.Tensor) -> torch.Tensor:
    """8x8 blockwise DCT-quantize-IDCT round trip.

    img: [F, H, W, 3] (H, W multiples of 8, any centering); tab: [8, 8, 3].
    The quantised coefficients are rounded half to even, as jnp.round."""
    f, h, w, _ = img.shape
    d = _const(_DCT, img.device)
    blocks = img.reshape(f, h // 8, 8, w // 8, 8, 3).permute(0, 1, 3, 2, 4, 5)
    coeff = torch.einsum('ij,fabjkc,lk->fabilc', d, blocks, d)
    coeff = torch.round(coeff / tab) * tab
    rec = torch.einsum('ji,fabjkc,kl->fabilc', d, coeff, d)
    return rec.permute(0, 1, 3, 2, 4, 5).reshape(f, h, w, 3)


def jpeg_compress(x: torch.Tensor, quality: float) -> torch.Tensor:
    """DCT-quantization JPEG round trip at 4:4:4 (no chroma subsample —
    documented deviation from DiffJPEG's 4:2:0; quality scaling follows the
    libjpeg convention used by utils_jpeg.py)."""
    f, h, w, c = x.shape
    assert c == 3
    hp, wp = -(-h // 8) * 8, -(-w // 8) * 8
    ycc = _to_ycbcr(_pad_hw(x, 0, 'edge', hp, wp))
    q = torch.tensor(quality, dtype=torch.float32, device=x.device)
    scale = torch.where(q < 50, 5000.0 / q, 200.0 - 2.0 * q)
    rec = _dct_quant(ycc - 128.0, _quality_tables(scale)) + 128.0
    return _to_rgb01(rec, h, w)


# --------------------------------------------------------------------------
# codec round-trip: PyAV when available, device-side proxy otherwise
# --------------------------------------------------------------------------

def codec_proxy(frames01: torch.Tensor, seed: int,
                quality: float | None = None) -> torch.Tensor:
    """Device-side compression proxy for machines without a codec stack:
    4:2:0 chroma subsampling + intra DCT quantization of the first frame +
    quantized temporal-residual DCT for the following frames (DPCM), in a
    loop over the frames on the device (the JAX package's lax.scan) — the
    blocking + temporal-smear signature of the reference's H.264/mpeg4
    stage (degrade_video.py:48-76)."""
    rng = random.Random(seed)
    q = float(quality if quality is not None else rng.uniform(18.0, 40.0))
    f, h, w, c = frames01.shape
    assert c == 3
    hp, wp = -(-h // 16) * 16, -(-w // 16) * 16
    ycc = _to_ycbcr(_pad_hw(frames01, 0, 'edge', hp, wp))

    # 4:2:0: average 2x2 chroma, nearest-upsample back
    sub = ycc[..., 1:].reshape(f, hp // 2, 2, wp // 2, 2, 2).mean(dim=(2, 4))
    up = sub.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    ycc = torch.cat([ycc[..., :1], up], dim=-1)

    scale = (5000.0 / q) if q < 50 else (200.0 - 2.0 * q)
    tab = _quality_tables(torch.tensor(scale, dtype=torch.float32,
                                       device=ycc.device))

    # I-frame: intra quantization; P-frames: quantized DPCM residuals
    # (residual table 1.6x coarser, like inter-frame quant offsets)
    prev = _dct_quant(ycc[:1] - 128.0, tab)[0] + 128.0
    out = [prev]
    for cur in ycc[1:]:
        prev = prev + _dct_quant((cur - prev)[None], tab * 1.6)[0]
        out.append(prev)
    return _to_rgb01(torch.stack(out), h, w)


def codec_roundtrip(frames01: torch.Tensor, seed: int) -> torch.Tensor:
    """H.264/mpeg4 encode-decode via PyAV when available
    (degrade_video.py:19-76), on the host; the device-side codec_proxy
    (DCT-DPCM) otherwise, so the compression stage never silently
    vanishes. Returns frames on frames01's device."""
    try:
        import av
    except ImportError:
        logger.info('PyAV unavailable: using device-side codec proxy')
        return codec_proxy(frames01, seed)
    rng = random.Random(seed)
    codec = rng.choice(['libx264', 'mpeg4'])
    bitrate = rng.randint(int(1e4), int(1e5))
    f, h, w, _ = frames01.shape
    h2, w2 = h - h % 2, w - w % 2
    host = frames01.detach().cpu().numpy()
    buf = io.BytesIO()
    with av.open(buf, 'w', 'mp4') as container:
        stream = container.add_stream(codec, rate=1)
        stream.height, stream.width = h2, w2
        stream.pix_fmt = 'yuv420p'
        stream.bit_rate = bitrate
        for img in host[:, :h2, :w2]:
            frame = av.VideoFrame.from_ndarray(
                (img * 255).clip(0, 255).astype(np.uint8), format='rgb24')
            for packet in stream.encode(frame):
                container.mux(packet)
        for packet in stream.encode():
            container.mux(packet)
    out = []
    with av.open(buf, 'r', 'mp4') as container:
        for frame in container.decode(video=0):
            out.append(frame.to_rgb().to_ndarray().astype(np.float32) / 255)
    return torch.from_numpy(np.stack(out)).to(frames01.device)


# --------------------------------------------------------------------------
# full pipeline
# --------------------------------------------------------------------------

# draw(stage, kind, arg) -> the noise draws of one stage (1 or 2): for
# kind 'normal' the standard normals of shape `arg`, for 'poisson' the
# counts at the rate tensor `arg`
Draw = Callable[[int, str, object], torch.Tensor]


def _stage_noise(y: torch.Tensor, st: StageParams, stage: int,
                 draw: Optional[Draw], generator) -> torch.Tensor:
    if st.use_gaussian_noise:
        f, h, w, _ = y.shape
        shape = (f, h, w, 1) if st.gray_noise else tuple(y.shape)
        normal = draw(stage, 'normal', shape) if draw else None
        return add_gaussian_noise(y, st.noise_sigma, st.gray_noise,
                                  normal=normal, generator=generator)
    counts = (lambda rate: draw(stage, 'poisson', rate)) if draw else None
    return add_poisson_noise(y, st.poisson_scale, st.gray_noise,
                             counts=counts, generator=generator)


def degrade_video(gt01, scale: int = 4, seed: int = 0,
                  use_codec: bool = True, recipe: str = 'default',
                  device='cuda', draw: Optional[Draw] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """gt01: [F, H, W, 3] in [0, 1] (a tensor or numpy, put on `device`,
    the card unless device='cpu') -> (lq [F, H/scale, W/scale, 3],
    gt_usm), fp32 tensors on `device`. Mirrors Degradation.forward_deg (degrade_video.py:149-192;
    recipe='mid' follows degrade_video_mid.py's stage-1 resize-to-final),
    all frames at once. The noises are drawn from a torch.Generator seeded
    with `seed`, or by `draw`."""
    p = sample_degradation_params(seed, recipe)
    x = torch.as_tensor(gt01, dtype=torch.float32,
                        device=resolve_device(device))
    f, ori_h, ori_w, _ = x.shape
    generator = None
    if draw is None:
        generator = torch.Generator(device=x.device).manual_seed(seed)

    gt_usm = usm_sharpen(x)

    # ---- stage 1
    y = filter2d(gt_usm, p.stage1.kernel)
    s = p.stage1.resize_scale
    if recipe == 'mid':
        y = _resize(y, int(ori_h / scale * s), int(ori_w / scale * s),
                    p.stage1.resize_mode)
    else:
        y = _resize(y, int(ori_h * s), int(ori_w * s), p.stage1.resize_mode)
    y = _stage_noise(y, p.stage1, 1, draw, generator)
    y = jpeg_compress(y, p.stage1.jpeg_quality)
    if use_codec:
        y = codec_roundtrip(y, seed * 2 + 1)

    # ---- stage 2
    if p.stage2.apply_blur:
        y = filter2d(y, p.stage2.kernel)
    s2 = p.stage2.resize_scale
    y = _resize(y, int(ori_h / scale * s2), int(ori_w / scale * s2),
                p.stage2.resize_mode)
    y = _stage_noise(y, p.stage2, 2, draw, generator)
    if p.sinc_before_jpeg:
        y = _resize(y, ori_h // scale, ori_w // scale, p.stage2.resize_mode)
        y = filter2d(y, p.sinc_kernel)
        y = jpeg_compress(y, p.stage2.jpeg_quality)
    else:
        y = jpeg_compress(y, p.stage2.jpeg_quality)
        y = _resize(y, ori_h // scale, ori_w // scale, p.stage2.resize_mode)
        y = filter2d(y, p.sinc_kernel)
    if use_codec:
        y = codec_roundtrip(y, seed * 2 + 2)
    lq = torch.clamp(torch.round(y * 255.0), 0, 255) / 255.0
    return lq, gt_usm


# --------------------------------------------------------------------------
# RealESRGAN image-pair extras (RealESRGAN_Deg_pipeline.py:320-407)
# --------------------------------------------------------------------------

def augment_paired(rng: np.random.RandomState, *imgs: torch.Tensor,
                   hflip: bool = True,
                   rotation: bool = True) -> Tuple[torch.Tensor, ...]:
    """Random hflip / vflip / rot90, the SAME draw applied to every input
    ([..., H, W, C] tensors). Mirrors Degradation.augment
    (RealESRGAN_Deg_pipeline.py:320-340) with an explicit RNG."""
    do_h = hflip and rng.random_sample() < 0.5
    do_v = rotation and rng.random_sample() < 0.5
    do_r = rotation and rng.random_sample() < 0.5

    def _one(img):
        if do_h:
            img = img.flip(-2)
        if do_v:
            img = img.flip(-3)
        if do_r:
            img = img.transpose(-3, -2)
        return img.contiguous()

    return tuple(_one(i) for i in imgs)


def paired_random_crop(rng: np.random.RandomState, gt: torch.Tensor,
                       lq: torch.Tensor, gt_patch_size: int,
                       scale: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Aligned random crop: lq gets gt_patch_size//scale, gt the scaled-up
    window at the same location ([..., H, W, C] tensors). Mirrors
    Degradation.paired_random_crop (RealESRGAN_Deg_pipeline.py:342-407)."""
    h_lq, w_lq = lq.shape[-3:-1]
    h_gt, w_gt = gt.shape[-3:-1]
    lq_patch = gt_patch_size // scale
    if h_gt != h_lq * scale or w_gt != w_lq * scale:
        raise ValueError(f'scale mismatch: gt {h_gt}x{w_gt} is not {scale}x '
                         f'lq {h_lq}x{w_lq}')
    if h_lq < lq_patch or w_lq < lq_patch:
        raise ValueError(f'lq {h_lq}x{w_lq} smaller than patch {lq_patch}')
    top = rng.randint(0, h_lq - lq_patch + 1)
    left = rng.randint(0, w_lq - lq_patch + 1)
    lq_c = lq[..., top:top + lq_patch, left:left + lq_patch, :]
    gt_c = gt[..., top * scale:top * scale + gt_patch_size,
              left * scale:left * scale + gt_patch_size, :]
    return gt_c.contiguous(), lq_c.contiguous()


def realesrgan_image_pair(gt01_img, scale: int = 4, gt_size: int = 256,
                          seed: int = 0, device='cuda',
                          draw: Optional[Draw] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-image training pair per RealESRGAN_Deg_pipeline.Degradation:
    augment -> two-stage degradation (no codec stage) -> clamp/round ->
    paired random crop. gt01_img [H, W, 3] in [0,1] ->
    (gt_crop, gt_usm_crop, lq_crop), on `device` (the card unless
    device='cpu')."""
    rng = np.random.RandomState(seed)
    img = torch.as_tensor(gt01_img, dtype=torch.float32,
                          device=resolve_device(device))
    (img,) = augment_paired(rng, img)
    lq, gt_usm = degrade_video(img[None], scale=scale, seed=seed,
                               use_codec=False, device=img.device, draw=draw)
    gt_c, lq_c = paired_random_crop(rng, torch.stack([img, gt_usm[0]]), lq,
                                    gt_size, scale)
    return gt_c[0], gt_c[1], lq_c[0]
