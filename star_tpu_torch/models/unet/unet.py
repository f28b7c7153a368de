"""The STAR I2VGen-XL video UNet + video ControlNet
(counterpart of star_tpu/models/unet/unet.py).

I/O is channels-last video [B, F, H, W, C]; the spatial stream runs as
[B*F, H, W, C]. One trunk class builds both networks: the ControlNet variant
adds zero convs and returns the 13 control residuals, the UNet variant
consumes them and runs the decoder.

cfg_pair: x/t/hint carry one copy of a CFG pair while y carries both
halves ([2B, ...]). The two streams are identical until the first text
cross-attention, so everything before it runs at batch B and is tiled at
that point (skip taps and control residuals included).

remat (training): under grad, each ResBlock, SpatialTransformer and
TemporalTransformer runs under torch.utils.checkpoint, which keeps only
its inputs and recomputes it in the backward, as the JAX package wraps the
same blocks in nn.remat.

Dropout: with `deterministic=False` the forward takes a DropoutMasks
(blocks.py) and each ResBlock drops at its own rate (`dropout`) and its
temporal conv block at 0.1, as the JAX modules do; the masks are cached by
site, so remat's recompute reuses them. `deterministic=True` (inference,
and the training CLIs) runs the fused chains.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...utils.profiling import spanned
from ..layers import Conv2d, GroupNorm, zero_
from .blocks import (DropoutMasks, Downsample, ResBlock, SpatialTransformer,
                     TemporalTransformer, Upsample, name_dropout_sites,
                     silu32, sinusoidal_embedding)


class VideoUNetTrunk(nn.Module):
    """Encoder + middle of the video UNet; then the decoder (UNet mode) or
    the zero-conv taps (ControlNet mode)."""

    def __init__(self, dim: int = 320, in_channels: int = 4,
                 out_channels: int = 4,
                 dim_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2,
                 attn_scales: Sequence[float] = (1.0, 0.5, 0.25),
                 head_dim: int = 64, num_heads_init_temporal: int = 8,
                 context_dim: int = 1024, dropout: float = 0.1,
                 is_controlnet: bool = False, remat: bool = False):
        super().__init__()
        self.dim, self.head_dim = dim, head_dim
        self.dropout, self.remat = dropout, remat
        self.dim_mult = tuple(dim_mult)
        self.num_res_blocks = num_res_blocks
        self.attn_scales = tuple(attn_scales)
        self.is_controlnet = is_controlnet
        self.out_channels = out_channels
        hd, emb = head_dim, dim * 4
        spatial = lambda c: SpatialTransformer(c, c // hd, hd, context_dim)
        temporal = lambda c, h=None: TemporalTransformer(
            c, c // hd if h is None else h, hd)

        self.time_embed_1 = nn.Linear(dim, emb)
        self.time_embed_2 = nn.Linear(emb, emb)
        self.conv_in = Conv2d(in_channels, dim, 3, padding=1)
        if is_controlnet:
            self.input_hint = zero_(Conv2d(in_channels, dim, 3, padding=1))
        self.init_temporal = temporal(dim, num_heads_init_temporal)

        taps = [dim]          # channels of each skip tap, in order
        enc_dims = [dim * u for u in (1,) + self.dim_mult]
        scale, ch = 1.0, dim
        for i, out_d in enumerate(enc_dims[1:]):
            for j in range(num_res_blocks):
                setattr(self, f'enc_{i}_{j}_res',
                        ResBlock(ch, out_d, emb, dropout))
                ch = out_d
                if scale in self.attn_scales:
                    setattr(self, f'enc_{i}_{j}_spatial', spatial(out_d))
                    setattr(self, f'enc_{i}_{j}_temporal', temporal(out_d))
                taps.append(ch)
            if i != len(self.dim_mult) - 1:
                setattr(self, f'enc_{i}_down', Downsample(out_d))
                scale /= 2.0
                taps.append(ch)
        mid = enc_dims[-1]
        self.mid_res1 = ResBlock(mid, mid, emb, dropout)
        self.mid_spatial = spatial(mid)
        self.mid_temporal = temporal(mid)
        self.mid_res2 = ResBlock(mid, mid, emb, dropout)

        if is_controlnet:
            for k, c in enumerate(taps):
                setattr(self, f'zero_conv_{k}', zero_(Conv2d(c, c, 1)))
            self.middle_out = zero_(Conv2d(mid, mid, 1))
            name_dropout_sites(self)
            return

        dec_dims = [dim * u for u in (self.dim_mult[-1],)
                    + self.dim_mult[::-1]]
        for i, out_d in enumerate(dec_dims[1:]):
            for j in range(num_res_blocks + 1):
                skip = taps.pop()
                setattr(self, f'dec_{i}_{j}_res',
                        ResBlock(ch + skip, out_d, emb, dropout))
                ch = out_d
                if scale in self.attn_scales:
                    setattr(self, f'dec_{i}_{j}_spatial', spatial(out_d))
                    setattr(self, f'dec_{i}_{j}_temporal', temporal(out_d))
                if i != len(self.dim_mult) - 1 and j == num_res_blocks:
                    setattr(self, f'dec_{i}_up', Upsample(out_d))
                    scale *= 2.0
        self.head_norm = GroupNorm(dim)
        self.head_conv = zero_(Conv2d(dim, out_channels, 3, padding=1))
        name_dropout_sites(self)

    def forward(self, x: torch.Tensor, t: torch.Tensor, y: torch.Tensor,
                hint: Optional[torch.Tensor] = None,
                controls: Optional[Tuple[torch.Tensor, ...]] = None,
                cfg_pair: bool = False, deterministic: bool = True,
                dropout_masks: Optional[DropoutMasks] = None):
        """dropout_masks: the masks of this forward, needed with
        deterministic=False."""
        if not deterministic and dropout_masks is None:
            raise ValueError('deterministic=False draws dropout masks: pass '
                             'dropout_masks=DropoutMasks(generator)')
        masks = None if deterministic else dropout_masks
        b, f, hh, ww, cin = x.shape
        dtype = self.conv_in.weight.dtype
        w1, w2 = self.time_embed_1, self.time_embed_2
        e = sinusoidal_embedding(t, self.dim)
        e = F.linear(e, w1.weight.float(), w1.bias.float())
        e = F.linear(F.silu(e), w2.weight.float(), w2.bias.float())
        e = e.to(dtype).repeat_interleave(f, dim=0)            # [BF, E]
        context = y.to(dtype).repeat_interleave(f, dim=0)      # [BF, L, Cc]
        if cfg_pair:
            assert y.shape[0] == 2 * b, (y.shape, b)
        x = x.to(dtype).reshape(b * f, hh, ww, cin)

        xs = []
        state = {'split_pending': cfg_pair, 'e': e}
        remat = self.remat and torch.is_grad_enabled()

        def run(mod, *args):
            if remat:
                return checkpoint(mod, *args, use_reentrant=False)
            return mod(*args)

        def run_spatial(name, x):
            mod = getattr(self, name)
            if state['split_pending']:
                x = run(mod, x, context, True)
                # the pair diverges here: everything downstream runs at 2B
                state['split_pending'] = False
                state['e'] = torch.cat([state['e'], state['e']], dim=0)
                xs[:] = [torch.cat([s, s], dim=0) for s in xs]
                return x
            return run(mod, x, context, False)

        def run_temporal(name, x):
            bf = x.shape[0]
            x5 = run(getattr(self, name), x.reshape(-1, f, *x.shape[1:]))
            return x5.reshape(bf, *x.shape[1:])

        def tap(xcur):
            if self.is_controlnet:
                xs.append(getattr(self, f'zero_conv_{len(xs)}')(xcur))
            else:
                xs.append(xcur)

        x = self.conv_in(x)
        if self.is_controlnet:
            assert hint is not None
            x = x + self.input_hint(hint.to(dtype).reshape(b * f, hh, ww, -1))
        x = run_temporal('init_temporal', x)
        tap(x)

        scale = 1.0
        for i in range(len(self.dim_mult)):
            for j in range(self.num_res_blocks):
                x = run(getattr(self, f'enc_{i}_{j}_res'), x, state['e'], f,
                        masks)
                if scale in self.attn_scales:
                    x = run_spatial(f'enc_{i}_{j}_spatial', x)
                    x = run_temporal(f'enc_{i}_{j}_temporal', x)
                tap(x)
            if i != len(self.dim_mult) - 1:
                x = getattr(self, f'enc_{i}_down')(x)
                scale /= 2.0
                tap(x)

        x = run(self.mid_res1, x, state['e'], f, masks)
        x = run_spatial('mid_spatial', x)
        x = run_temporal('mid_temporal', x)
        x = run(self.mid_res2, x, state['e'], f, masks)

        if self.is_controlnet:
            xs.append(self.middle_out(x))
            return tuple(xs)

        controls_list = list(controls) if controls is not None else None
        if controls_list is not None:
            x = x + controls_list.pop().to(dtype)
        for i in range(len(self.dim_mult)):
            for j in range(self.num_res_blocks + 1):
                skip = xs.pop()
                if controls_list is not None:
                    skip = skip + controls_list.pop().to(dtype)
                x = torch.cat([x, skip], dim=-1)
                x = run(getattr(self, f'dec_{i}_{j}_res'), x, state['e'], f,
                        masks)
                if scale in self.attn_scales:
                    x = run_spatial(f'dec_{i}_{j}_spatial', x)
                    x = run_temporal(f'dec_{i}_{j}_temporal', x)
                if i != len(self.dim_mult) - 1 and j == self.num_res_blocks:
                    x = getattr(self, f'dec_{i}_up')(x)
                    scale *= 2.0

        x = self.head_conv(silu32(self.head_norm(x)))
        if state['split_pending']:   # cfg_pair with no cross-attn: tile late
            x = torch.cat([x, x], dim=0)
        return x.reshape(-1, f, hh, ww, self.out_channels)


class ControlledV2VUNet(nn.Module):
    """UNet + video ControlNet; hint is the LQ latent.
    forward(x, t, y, hint) -> v-prediction [B, F, H, W, 4] ([2B, ...] with
    cfg_pair, in y's half order). `remat` is the flag of both trunks."""

    def __init__(self, dim: int = 320, dim_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2,
                 attn_scales: Sequence[float] = (1.0, 0.5, 0.25),
                 head_dim: int = 64, num_heads_init_temporal: int = 8,
                 context_dim: int = 1024, dropout: float = 0.1,
                 remat: bool = False):
        super().__init__()
        kw = dict(dim=dim, dim_mult=dim_mult, num_res_blocks=num_res_blocks,
                  attn_scales=attn_scales, head_dim=head_dim,
                  num_heads_init_temporal=num_heads_init_temporal,
                  context_dim=context_dim, dropout=dropout, remat=remat)
        self.unet = VideoUNetTrunk(**kw)
        self.controlnet = VideoUNetTrunk(is_controlnet=True, **kw)
        name_dropout_sites(self)

    @spanned('unet.call')
    def forward(self, x, t, y, hint, cfg_pair: bool = False,
                deterministic: bool = True,
                dropout_masks: Optional[DropoutMasks] = None):
        controls = self.controlnet(x, t, y, hint=hint, cfg_pair=cfg_pair,
                                   deterministic=deterministic,
                                   dropout_masks=dropout_masks)
        return self.unet(x, t, y, controls=controls, cfg_pair=cfg_pair,
                         deterministic=deterministic,
                         dropout_masks=dropout_masks)
