"""Stable-Video-Diffusion temporal-decoder VAE
(counterpart of star_tpu/vae/svd_vae.py).

An SD 2D encoder (128 channels, mults [1,2,4,4], mid attention, double-z
latents, scaling 0.18215) and SVD's TemporalDecoder (SpatioTemporalResBlocks
with the learned AlphaBlender, (3,1,1) temporal convs, time_conv_out).
Channels-last; decode folds the independent 3-frame windows into the batch.

GroupNorm statistics thread between blocks: each fused conv emits the
(sum, sumsq) of its output, so the next GN does not re-read it. On the
card the 3x3 convs of the res blocks run the fused GN+SiLU+conv kernel K6
(ops/conv3x3.py; the encoder's conv_out, 512 -> 8, stays plain), the
decoder upsamples the fused upsample-conv kernel K7, or the phase convs and
the interleave kernel K8 at widths K7 does not take (ops/upsample_conv.py),
the temporal convs the fused kernel K5 and the mid attention the d=512
flash kernel K2.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import Conv2d, GroupNorm, NormParams, TConvParams
from ..ops.attention import dot_product_attention
from ..ops.conv3x3 import (Stats, channel_stats, fused_gn_silu_conv3x3,
                           gn_coeffs)
from ..ops.fused_temporal_conv import fused_gn_silu_tconv3
from ..ops.upsample_conv import upsample_conv2x

SVD_VAE_SCALING = 0.18215


class ResnetBlock2D(nn.Module):
    """SD VAE residual block: GN -> SiLU -> conv, twice, with a skip."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.norm1 = NormParams(in_channels)
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = NormParams(out_channels)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x, stats: Stats | None = None,
                want_stats: bool = False):
        short = x if self.conv_shortcut is None else self.conv_shortcut(x)
        h, st1 = fused_gn_silu_conv3x3(x, self.norm1.weight, self.norm1.bias,
                                       self.conv1.weight, self.conv1.bias,
                                       stats=stats, want_stats=True)
        return fused_gn_silu_conv3x3(h, self.norm2.weight, self.norm2.bias,
                                     self.conv2.weight, self.conv2.bias,
                                     stats=st1, residual=short,
                                     want_stats=want_stats)


class TemporalResnetBlock(nn.Module):
    """(3,1,1) temporal-conv residual block on [B, F, H, W, C], both stages
    through the fused kernel K5 (temporal eps 1e-5).

    With `alpha`, the AlphaBlender mix folds into the second conv:
    (1-a)*h + a*(conv2 + h) == h + a*conv2, so conv2's kernel and bias are
    scaled by a and the block input stays the residual; the output's
    per-frame statistics come out of the same kernel call."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.norm1 = NormParams(in_channels)
        self.conv1 = TConvParams(in_channels, out_channels)
        self.norm2 = NormParams(out_channels)
        self.conv2 = TConvParams(out_channels, out_channels)
        self.conv_shortcut = (Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x, stats: Stats | None = None,
                alpha: torch.Tensor | None = None, want_stats: bool = False):
        b, f, hh, ww, c = x.shape
        cout = self.conv2.weight.shape[-1]
        xf = x.reshape(b, f, hh * ww, c)
        if stats is not None:   # per-frame [B*F, C] sums -> per video
            s, s2 = stats
            stats = (s.reshape(b, f, c).sum(1), s2.reshape(b, f, c).sum(1))
        if self.conv_shortcut is None:
            short = xf
        else:
            short = self.conv_shortcut(x.reshape(b * f, hh, ww, c)).reshape(
                b, f, hh * ww, cout)
        h, st1 = fused_gn_silu_tconv3(xf, self.norm1.weight, self.norm1.bias,
                                      self.conv1.weight, self.conv1.bias,
                                      stats=stats, want_stats=True, eps=1e-5)
        if alpha is not None:
            assert c == cout, 'the alpha fold needs in == out channels'
            out, st = fused_gn_silu_tconv3(
                h, self.norm2.weight, self.norm2.bias,
                self.conv2.weight * alpha, self.conv2.bias * alpha,
                stats=st1, residual=xf, eps=1e-5, want_stats=want_stats,
                stats_per_frame=True)
            return out.reshape(b, f, hh, ww, cout), st
        out, _ = fused_gn_silu_tconv3(h, self.norm2.weight, self.norm2.bias,
                                      self.conv2.weight, self.conv2.bias,
                                      stats=st1, residual=short, eps=1e-5)
        return out.reshape(b, f, hh, ww, cout), None


class SpatioTemporalResBlock(nn.Module):
    """Per-frame spatial res block + temporal res block + learned alpha
    blend: out = (1-sigmoid(m))*spatial + sigmoid(m)*temporal. With
    blend_fold the blend runs inside the temporal block's second conv."""

    def __init__(self, in_channels: int, out_channels: int,
                 blend_fold: bool = True):
        super().__init__()
        self.spatial_res_block = ResnetBlock2D(in_channels, out_channels)
        self.temporal_res_block = TemporalResnetBlock(out_channels,
                                                      out_channels)
        self.mix_factor = nn.Parameter(torch.full((1,), 0.5))
        self.blend_fold = blend_fold

    def forward(self, x, stats: Stats | None = None,
                want_stats: bool = False):
        b, f, hh, ww, c = x.shape
        h2d, st_sp = self.spatial_res_block(x.reshape(b * f, hh, ww, c),
                                            stats=stats, want_stats=True)
        h_sp = h2d.reshape(b, f, hh, ww, -1)
        alpha = torch.sigmoid(self.mix_factor)[0]
        if self.blend_fold:
            out, st = self.temporal_res_block(h_sp, stats=st_sp, alpha=alpha,
                                              want_stats=want_stats)
            return out, st
        h_tm, _ = self.temporal_res_block(h_sp, stats=st_sp)
        out = (1.0 - alpha).to(h_sp.dtype) * h_sp \
            + alpha.to(h_tm.dtype) * h_tm
        st = (channel_stats(out.reshape(b * f, hh * ww, -1))
              if want_stats else None)
        return out, st


class VaeAttention(nn.Module):
    """Single-head attention of the VAE mid stage (d = channels = 512 at
    full width: the flash kernel K2 at long sequences)."""

    def __init__(self, channels: int):
        super().__init__()
        self.group_norm = GroupNorm(channels, eps=1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.Linear(channels, channels)

    def forward(self, x):
        bf, hh, ww, c = x.shape
        h = self.group_norm(x).reshape(bf, hh * ww, c)
        q, k, v = (m(h)[:, :, None] for m in (self.to_q, self.to_k,
                                               self.to_v))
        h = dot_product_attention(q, k, v)[:, :, 0]
        return self.to_out(h).reshape(bf, hh, ww, c) + x


class Encoder(nn.Module):
    """SD 2D encoder -> 2*latent_channels moments; x [N, H, W, 3]."""

    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 512,
                                                            512),
                 layers_per_block: int = 2, latent_channels: int = 4):
        super().__init__()
        chs = tuple(block_out_channels)
        self.chs, self.layers = chs, layers_per_block
        self.conv_in = Conv2d(3, chs[0], 3, padding=1)
        cin = chs[0]
        for i, ch in enumerate(chs):
            for j in range(layers_per_block):
                setattr(self, f'down_{i}_res_{j}', ResnetBlock2D(cin, ch))
                cin = ch
            if i != len(chs) - 1:
                setattr(self, f'down_{i}_downsample',
                        Conv2d(ch, ch, 3, stride=2))
        self.mid_res_1 = ResnetBlock2D(chs[-1], chs[-1])
        self.mid_attn = VaeAttention(chs[-1])
        self.mid_res_2 = ResnetBlock2D(chs[-1], chs[-1])
        self.conv_norm_out = NormParams(chs[-1])
        self.conv_out = Conv2d(chs[-1], 2 * latent_channels, 3, padding=1)
        self.quant_conv = Conv2d(2 * latent_channels, 2 * latent_channels, 1)

    def forward(self, x):
        dtype = self.conv_in.weight.dtype
        h = self.conv_in(x.to(dtype))
        stats = None
        for i in range(len(self.chs)):
            for j in range(self.layers):
                h, stats = getattr(self, f'down_{i}_res_{j}')(
                    h, stats=stats, want_stats=True)
            if i != len(self.chs) - 1:
                # SD VAE downsample: pad (0, 1) right/bottom, stride-2 conv
                h = getattr(self, f'down_{i}_downsample')(
                    F.pad(h, (0, 0, 0, 1, 0, 1)))
                stats = None
        h, _ = self.mid_res_1(h, stats=stats)
        h = self.mid_attn(h)
        h, stats = self.mid_res_2(h, want_stats=True)
        h, _ = fused_gn_silu_conv3x3(
            h, self.conv_norm_out.weight, self.conv_norm_out.bias,
            self.conv_out.weight, self.conv_out.bias, stats=stats)
        return self.quant_conv(h)


class TemporalDecoder(nn.Module):
    """SVD temporal decoder: z [B, F, h, w, 4] -> [B, F, 8h, 8w, 3]."""

    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 512,
                                                            512),
                 layers_per_block: int = 2, out_channels: int = 3,
                 latent_channels: int = 4, blend_fold: bool = True):
        super().__init__()
        chs = list(reversed(block_out_channels))       # [512, 512, 256, 128]
        self.chs, self.layers = chs, layers_per_block
        st = lambda i, o: SpatioTemporalResBlock(i, o, blend_fold)
        self.conv_in = Conv2d(latent_channels, chs[0], 3, padding=1)
        self.mid_res_0 = st(chs[0], chs[0])
        self.mid_attn = VaeAttention(chs[0])
        self.mid_res_1 = st(chs[0], chs[0])
        cin = chs[0]
        for i, ch in enumerate(chs):
            for j in range(layers_per_block + 1):
                setattr(self, f'up_{i}_res_{j}', st(cin, ch))
                cin = ch
            if i != len(chs) - 1:
                setattr(self, f'up_{i}_upsample', Conv2d(ch, ch, 3,
                                                         padding=1))
        self.conv_norm_out = NormParams(chs[-1])
        self.conv_out = Conv2d(chs[-1], out_channels, 3, padding=1)
        self.time_conv_out = TConvParams(out_channels, out_channels)

    def forward(self, z):
        b, f, hh, ww, cz = z.shape
        dtype = self.conv_in.weight.dtype
        x = self.conv_in(z.to(dtype).reshape(b * f, hh, ww, cz))
        x = x.reshape(b, f, hh, ww, -1)
        x, _ = self.mid_res_0(x)
        x = self.mid_attn(x.reshape(b * f, hh, ww, -1)).reshape(
            b, f, hh, ww, -1)
        x, stats = self.mid_res_1(x, want_stats=True)
        for i, ch in enumerate(self.chs):
            for j in range(self.layers + 1):
                x, stats = getattr(self, f'up_{i}_res_{j}')(
                    x, stats=stats, want_stats=True)
            if i != len(self.chs) - 1:
                _, fq, hq, wq, cq = x.shape
                up = getattr(self, f'up_{i}_upsample')
                x2, stats = upsample_conv2x(x.reshape(b * fq, hq, wq, cq),
                                            up.weight, up.bias,
                                            want_stats=True)
                x = x2.reshape(b, fq, 2 * hq, 2 * wq, cq)

        _, f2, h2, w2, c2 = x.shape
        # conv_norm_out normalises the frame-flattened tensor: per-frame
        # statistics (the threaded stats are already per frame)
        x4 = x.reshape(b * f2, h2, w2, c2)
        a, bb = gn_coeffs(stats, h2 * w2 * (c2 // 32),
                          self.conv_norm_out.weight, self.conv_norm_out.bias,
                          32, 1e-6)
        x4 = F.silu(x4 * a.to(dtype)[:, None, None]
                    + bb.to(dtype)[:, None, None])
        x = self.conv_out(x4).reshape(b, f2, h2 * w2, -1)
        x = temporal_conv3(x, self.time_conv_out.weight,
                           self.time_conv_out.bias)
        return x.reshape(b, f2, h2, w2, -1)


def temporal_conv3(x: torch.Tensor, kernel: torch.Tensor,
                   bias: torch.Tensor) -> torch.Tensor:
    """Plain (3,1,1) conv over frames, SAME padding, fp32 accumulation:
    x [B, F, N, Cin], kernel [3, 1, Cin, Cout] -> [B, F, N, Cout]."""
    f = x.shape[1]
    xp = F.pad(x.float(), (0, 0, 0, 0, 1, 1))
    k = kernel[:, 0].float()
    y = sum(torch.matmul(xp[:, tap:tap + f], k[tap]) for tap in range(3))
    return (y + bias.float()).to(x.dtype)


class SVDTemporalVAE(nn.Module):
    """encode(video) -> scaled latents; decode(latents) -> video.

    Frames are [B, F, H, W, 3] in [-1, 1]; latents [B, F, H/8, W/8, 4]
    pre-multiplied by SVD_VAE_SCALING. blend_fold selects the AlphaBlender
    fold into the temporal conv (True) or the explicit blend (False)."""

    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 512,
                                                            512),
                 encoder_layers: int = 2, decoder_layers: int = 2,
                 decode_window: int = 3, decode_batch: int = 3,
                 blend_fold: bool = True):
        super().__init__()
        self.encoder = Encoder(block_out_channels, encoder_layers)
        self.decoder = TemporalDecoder(block_out_channels, decoder_layers,
                                       blend_fold=blend_fold)
        self.decode_window, self.decode_batch = decode_window, decode_batch

    def encode_moments(self, video):
        b, f, hh, ww, c = video.shape
        moments = self.encoder(video.reshape(b * f, hh, ww, c))
        return moments.reshape(b, f, hh // 8, ww // 8, -1)

    def encode(self, video, generator: torch.Generator | None = None,
               eps: torch.Tensor | None = None):
        """-> scaled latents [B, F, h, w, 4], a sample of the posterior:
        eps is drawn from `generator` unless given."""
        mean, logvar = self.encode_moments(video).chunk(2, dim=-1)
        std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0).float())
        if eps is None:
            eps = torch.randn(mean.shape, generator=generator,
                              device=mean.device)
        mean = mean + std.to(mean.dtype) * eps.to(mean.device, mean.dtype)
        return mean * SVD_VAE_SCALING

    def decode(self, latents):
        """Scaled latents [B, F, h, w, 4] -> video [B, F, 8h, 8w, 3]. Each
        3-frame window sees zero temporal padding at its edges; up to
        decode_batch windows decode together, folded into the batch."""
        z = latents / SVD_VAE_SCALING
        b, f, hh, ww, c = z.shape
        win = self.decode_window
        n_full = f // win
        gb = max(1, min(self.decode_batch, n_full if n_full else 1))
        outs = []
        if n_full:
            n_grp = n_full // gb
            n_head = n_grp * gb
            if n_grp:
                zw = z[:, :n_head * win].reshape(b, n_grp, gb, win, hh, ww, c)
                zw = zw.permute(1, 2, 0, 3, 4, 5, 6).reshape(
                    n_grp, gb * b, win, hh, ww, c)
                dec = torch.stack([self.decoder(zw[g]) for g in range(n_grp)])
                dec = dec.reshape(n_grp, gb, b, win, hh * 8, ww * 8, -1)
                dec = dec.permute(2, 0, 1, 3, 4, 5, 6)
                outs.append(dec.reshape(b, n_head * win, hh * 8, ww * 8, -1))
            for i in range(n_head, n_full):
                outs.append(self.decoder(z[:, i * win:(i + 1) * win]))
        if f - n_full * win:
            outs.append(self.decoder(z[:, n_full * win:]))
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
