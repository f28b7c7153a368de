"""CogVideoX causal 3D VAE (counterpart of star_tpu/vae/causal_vae.py,
without its context-parallel functions).

Defaults are the published config (cogvideox_5b_infer_sr.yaml): ch 128,
mult (1, 2, 2, 4), 3 res blocks, z 16, scale factor 0.7. Channels-last
video [B, T, H, W, C]. As in the JAX package:

  * causal time convs: k-1 frames of front padding that replicate frame 0
    at the clip start, or carry the previous window's last input frames;
    the carried frames travel in an explicit dict (`decode_window`), one
    entry per causal conv, passed in and returned;
  * first-frame-aware time down/upsampling (an odd frame count keeps frame
    0 uncompressed): 25 frames <-> 7 latent frames;
  * GroupNorm (32 groups, eps 1e-6) over the whole video of each call, and
    SpatialNorm3D (zq-modulated GN) in the decoder;
  * nearest resizes sample at half-pixel centres (jax.image.resize
    'nearest'), by explicit indices.

The convs are F.conv3d / F.conv2d: the JAX package leaves them to XLA.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import Conv2d, GroupNorm
from ..models.unet.blocks import silu32

COGVIDEO_VAE_SCALING = 0.7


@dataclasses.dataclass
class ChunkCache:
    """The causal convs' carried frames in one windowed decode call: read
    from `old` (the previous window's `new`) unless this is the first
    window, and written to `new`."""
    old: dict
    first: bool
    new: dict = dataclasses.field(default_factory=dict)


class CausalConv3d(nn.Conv3d):
    """3D conv with causal time padding on [B, T, H, W, C] (weight OIDHW)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Sequence[int] = (3, 3, 3)):
        kt, kh, kw = kernel_size
        super().__init__(in_channels, out_channels, tuple(kernel_size),
                         padding=(0, kh // 2, kw // 2))
        self.cache_key = ''   # the module's name in the VAE (CogVideoVAE)

    def forward(self, x: torch.Tensor,
                cache: Optional[ChunkCache] = None) -> torch.Tensor:
        kt = self.kernel_size[0]
        if kt > 1:
            if cache is not None and not cache.first:
                front = cache.old[self.cache_key]
            else:
                front = x[:, :1].expand(-1, kt - 1, -1, -1, -1)
            x = torch.cat([front, x], dim=1)
            if cache is not None:
                cache.new[self.cache_key] = x[:, -(kt - 1):].clone()
        y = F.conv3d(x.permute(0, 4, 1, 2, 3), self.weight.to(x.dtype),
                     self.bias.to(x.dtype), 1, self.padding)
        return y.permute(0, 2, 3, 4, 1)


def _nearest_index(m: int, n: int, device) -> torch.Tensor:
    """Source index of each of n outputs resized from m, at half-pixel
    centres in float32 (what jax.image.resize 'nearest' computes)."""
    pos = (np.arange(n, dtype=np.float32) + np.float32(0.5)) \
        * np.float32(m) / np.float32(n)
    return torch.from_numpy(np.floor(pos).astype(np.int64)).to(device)


def resize_nearest(x: torch.Tensor, size: Sequence[int],
                   first_dim: int = 1) -> torch.Tensor:
    """Nearest resize of the axes first_dim, first_dim+1, ... of x to
    `size`."""
    for i, n in enumerate(size):
        d = first_dim + i
        if x.shape[d] != n:
            x = x.index_select(d, _nearest_index(x.shape[d], n, x.device))
    return x


def interp_nearest_video(zq: torch.Tensor, t: int, hh: int,
                         ww: int) -> torch.Tensor:
    """First-frame-aware nearest resize of zq [B, Tz, h, w, C] to
    (t, hh, ww)."""
    if t > 1 and t % 2 == 1 and zq.shape[1] > 1:
        return torch.cat([resize_nearest(zq[:, :1], (1, hh, ww)),
                          resize_nearest(zq[:, 1:], (t - 1, hh, ww))], dim=1)
    return resize_nearest(zq, (t, hh, ww))


class SpatialNorm3D(nn.Module):
    """GN(f) * conv_y(zq) + conv_b(zq), zq resized to f's grid."""

    def __init__(self, channels: int, z_channels: int):
        super().__init__()
        self.norm = GroupNorm(channels, 32, eps=1e-6)
        self.conv_y = CausalConv3d(z_channels, channels, (1, 1, 1))
        self.conv_b = CausalConv3d(z_channels, channels, (1, 1, 1))

    def forward(self, f: torch.Tensor, zq: torch.Tensor) -> torch.Tensor:
        _, t, hh, ww, _ = f.shape
        zq = interp_nearest_video(zq.to(f.dtype), t, hh, ww)
        return self.norm(f) * self.conv_y(zq) + self.conv_b(zq)


class ResnetBlock3D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 z_channels: int | None = None):
        super().__init__()
        if z_channels is None:      # the encoder's plain GroupNorms
            self.norm1 = GroupNorm(in_channels, 32, eps=1e-6)
            self.norm2 = GroupNorm(out_channels, 32, eps=1e-6)
        else:                       # the decoder's SpatialNorm3D
            self.norm1 = SpatialNorm3D(in_channels, z_channels)
            self.norm2 = SpatialNorm3D(out_channels, z_channels)
        self.conv1 = CausalConv3d(in_channels, out_channels)
        self.conv2 = CausalConv3d(out_channels, out_channels)
        self.nin_shortcut = (CausalConv3d(in_channels, out_channels,
                                          (1, 1, 1))
                             if in_channels != out_channels else None)

    def _norm(self, norm, x, zq):
        return norm(x) if zq is None else norm(x, zq)

    def forward(self, x, zq=None, cache: Optional[ChunkCache] = None):
        h = silu32(self._norm(self.norm1, x, zq))
        h = self.conv1(h, cache)
        h = silu32(self._norm(self.norm2, h, zq))
        h = self.conv2(h, cache)
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class DownSample3D(nn.Module):
    """compress_time: average frame pairs (frame 0 kept when T is odd);
    then pad (0, 1) at the bottom and right and a stride-2 3x3 conv per
    frame."""

    def __init__(self, channels: int, compress_time: bool):
        super().__init__()
        self.compress_time = compress_time
        self.conv = Conv2d(channels, channels, 3, stride=2)

    def forward(self, x):
        b, t, hh, ww, c = x.shape
        if self.compress_time and t > 1:
            if t % 2 == 1:
                rest = x[:, 1:].reshape(b, (t - 1) // 2, 2, hh, ww, c) \
                    .mean(dim=2)
                x = torch.cat([x[:, :1], rest], dim=1)
            else:
                x = x.reshape(b, t // 2, 2, hh, ww, c).mean(dim=2)
            t = x.shape[1]
        xf = F.pad(x.reshape(b * t, hh, ww, c), (0, 0, 0, 1, 0, 1))
        return self.conv(xf).reshape(b, t, hh // 2, ww // 2, -1)


class UpSample3D(nn.Module):
    """Spatial nearest 2x, and with compress_time temporal nearest 2x with
    frame 0 kept single when T is odd; then a 3x3 conv per frame."""

    def __init__(self, channels: int, compress_time: bool):
        super().__init__()
        self.compress_time = compress_time
        self.conv = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        b, t, hh, ww, c = x.shape
        if self.compress_time and t > 1 and t % 2 == 1:
            x = torch.cat([resize_nearest(x[:, :1], (1, 2 * hh, 2 * ww)),
                           resize_nearest(x[:, 1:],
                                          (2 * (t - 1), 2 * hh, 2 * ww))],
                          dim=1)
        elif self.compress_time and t > 1:
            x = resize_nearest(x, (2 * t, 2 * hh, 2 * ww))
        else:
            x = resize_nearest(x, (2 * hh, 2 * ww), first_dim=2)
        b2, t2, h2, w2, _ = x.shape
        return self.conv(x.reshape(b2 * t2, h2, w2, c)) \
            .reshape(b2, t2, h2, w2, -1)


class CausalEncoder3D(nn.Module):
    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 2, 4),
                 num_res_blocks: int = 3, z_channels: int = 16,
                 temporal_compress_level: int = 2):
        super().__init__()
        chs = [ch * m for m in ch_mult]
        self.n_lv, self.num_res_blocks = len(ch_mult), num_res_blocks
        self.conv_in = CausalConv3d(3, ch)
        cin = ch
        for i in range(self.n_lv):
            for j in range(num_res_blocks):
                setattr(self, f'down_{i}_block_{j}',
                        ResnetBlock3D(cin, chs[i]))
                cin = chs[i]
            if i != self.n_lv - 1:
                setattr(self, f'down_{i}_downsample',
                        DownSample3D(chs[i], i < temporal_compress_level))
        self.mid_block_1 = ResnetBlock3D(chs[-1], chs[-1])
        self.mid_block_2 = ResnetBlock3D(chs[-1], chs[-1])
        self.norm_out = GroupNorm(chs[-1], 32, eps=1e-6)
        self.conv_out = CausalConv3d(chs[-1], 2 * z_channels)  # mean, logvar

    def forward(self, x):
        h = self.conv_in(x.to(self.conv_in.weight.dtype))
        for i in range(self.n_lv):
            for j in range(self.num_res_blocks):
                h = getattr(self, f'down_{i}_block_{j}')(h)
            if i != self.n_lv - 1:
                h = getattr(self, f'down_{i}_downsample')(h)
        h = self.mid_block_2(self.mid_block_1(h))
        return self.conv_out(silu32(self.norm_out(h)))


class CausalDecoder3D(nn.Module):
    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 2, 4),
                 num_res_blocks: int = 3, z_channels: int = 16,
                 temporal_compress_level: int = 2):
        super().__init__()
        chs = [ch * m for m in ch_mult]
        self.n_lv, self.num_res_blocks = len(ch_mult), num_res_blocks
        zc = z_channels
        self.conv_in = CausalConv3d(zc, chs[-1])
        self.mid_block_1 = ResnetBlock3D(chs[-1], chs[-1], zc)
        self.mid_block_2 = ResnetBlock3D(chs[-1], chs[-1], zc)
        cin = chs[-1]
        for i in reversed(range(self.n_lv)):
            for j in range(num_res_blocks + 1):
                setattr(self, f'up_{i}_block_{j}',
                        ResnetBlock3D(cin, chs[i], zc))
                cin = chs[i]
            if i != 0:
                setattr(self, f'up_{i}_upsample', UpSample3D(
                    cin, i >= self.n_lv - temporal_compress_level))
        self.norm_out = SpatialNorm3D(cin, zc)
        self.conv_out = CausalConv3d(cin, 3)

    def forward(self, z, cache: Optional[ChunkCache] = None):
        zq = z
        h = self.conv_in(z.to(self.conv_in.weight.dtype), cache)
        h = self.mid_block_1(h, zq, cache)
        h = self.mid_block_2(h, zq, cache)
        for i in reversed(range(self.n_lv)):
            for j in range(self.num_res_blocks + 1):
                h = getattr(self, f'up_{i}_block_{j}')(h, zq, cache)
            if i != 0:
                h = getattr(self, f'up_{i}_upsample')(h)
        h = silu32(self.norm_out(h, zq))
        return self.conv_out(h, cache)


class CogVideoVAE(nn.Module):
    """Encode and decode with the engine's 0.7 scale factor."""

    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 2, 4),
                 num_res_blocks: int = 3, z_channels: int = 16):
        super().__init__()
        kw = dict(ch=ch, ch_mult=tuple(ch_mult),
                  num_res_blocks=num_res_blocks, z_channels=z_channels)
        self.encoder = CausalEncoder3D(**kw)
        self.decoder = CausalDecoder3D(**kw)
        for name, mod in self.named_modules():
            if isinstance(mod, CausalConv3d):
                mod.cache_key = name

    def encode_moments(self, video: torch.Tensor) -> torch.Tensor:
        return self.encoder(video)

    def encode(self, video: torch.Tensor,
               generator: torch.Generator | None = None,
               eps: torch.Tensor | None = None) -> torch.Tensor:
        """[B, T, H, W, 3] -> scaled latents [B, (T-1)/4+1, H/8, W/8, z],
        a sample of the posterior: eps is drawn from `generator` unless
        given."""
        mean, logvar = self.encoder(video).chunk(2, dim=-1)
        std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0).float())
        if eps is None:
            eps = torch.randn(mean.shape, generator=generator,
                              device=mean.device)
        mean = mean + std.to(mean.dtype) * eps.to(mean.device, mean.dtype)
        return mean * COGVIDEO_VAE_SCALING

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """Scaled latents -> video, the whole clip in one call."""
        return self.decoder(latents / COGVIDEO_VAE_SCALING)

    def decode_window(self, latents: torch.Tensor, cache: dict,
                      first: bool) -> tuple[torch.Tensor, dict]:
        """One window of the serial decode: (video, the cache for the next
        window). The first window pads causally from its own frame 0; the
        others continue from `cache`, the previous window's."""
        cc = ChunkCache(old=cache, first=first)
        video = self.decoder(latents / COGVIDEO_VAE_SCALING, cc)
        return video, cc.new
