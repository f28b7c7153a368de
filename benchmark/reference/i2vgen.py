"""Plain float32 reference of STAR's I2VGen-XL towers: the OpenCLIP ViT-H
text tower (penultimate layer), the SVD VAE (SD 2D encoder, SVD temporal
decoder) and the video UNet + ControlNet with LIEM.

Each function reads its weights by the program's state-dict names from a
`Weights` and computes in float32 (or the float8 control, prims.Precision)
with plain PyTorch operations: no fused kernel, no threaded statistics, no
folded blends. Video is channels-last [B, F, H, W, C].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .prims import (Precision, Weights, attention, conv2d, group_norm,
                    layer_norm, linear, silu, tconv3)


# ------------------------------------------------------------------ text
def clip_text(p: Precision, w: Weights, tokens: torch.Tensor, heads: int,
              blocks: int) -> torch.Tensor:
    """tokens [B, 77] -> [B, 77, width]: causal pre-LN transformer of
    `blocks` blocks, then ln_final."""
    s = tokens.shape[1]
    x = w('token_embedding')[tokens.long()] + w('positional_embedding')[:s]
    mask = torch.triu(torch.full((s, s), float('-inf'), device=x.device),
                      diagonal=1)
    for i in range(blocks):
        b = w.sub(f'resblock_{i}')
        h = layer_norm(x, b('ln_1.weight'), b('ln_1.bias'))
        qkv = linear(p, h, b('attn.in_proj.weight'), b('attn.in_proj.bias'))
        q, k, v = qkv.chunk(3, dim=-1)
        a = attention(p, q, k, v, heads, mask=mask)
        x = x + linear(p, a, b('attn.out_proj.weight'),
                       b('attn.out_proj.bias'))
        h = layer_norm(x, b('ln_2.weight'), b('ln_2.bias'))
        h = F.gelu(linear(p, h, b('mlp_fc.weight'), b('mlp_fc.bias')))
        x = x + linear(p, h, b('mlp_proj.weight'), b('mlp_proj.bias'))
    return layer_norm(x, w('ln_final.weight'), w('ln_final.bias'))


# ------------------------------------------------------------------- VAE
def _res2d(p, w, x, eps=1e-6):
    """SD VAE residual block on [N, H, W, C]."""
    h = conv2d(p, silu(group_norm(x, w('norm1.weight'), w('norm1.bias'),
                                  eps=eps)),
               w('conv1.weight'), w('conv1.bias'), padding=1)
    h = conv2d(p, silu(group_norm(h, w('norm2.weight'), w('norm2.bias'),
                                  eps=eps)),
               w('conv2.weight'), w('conv2.bias'), padding=1)
    short = (conv2d(p, x, w('conv_shortcut.weight'), w('conv_shortcut.bias'))
             if w.has('conv_shortcut.weight') else x)
    return short + h


def _vae_attn(p, w, x):
    n, hh, ww, c = x.shape
    h = group_norm(x, w('group_norm.weight'), w('group_norm.bias'),
                   eps=1e-6).reshape(n, hh * ww, c)
    q, k, v = (linear(p, h, w(f'{m}.weight'), w(f'{m}.bias'))
               for m in ('to_q', 'to_k', 'to_v'))
    a = attention(p, q, k, v, 1)
    return linear(p, a, w('to_out.weight'), w('to_out.bias')).reshape(
        n, hh, ww, c) + x


def vae_encode_moments(p: Precision, w: Weights, x: torch.Tensor,
                       levels: int, layers: int) -> torch.Tensor:
    """x [N, H, W, 3] in [-1, 1] -> moments [N, H/8, W/8, 8]."""
    h = conv2d(p, x, w('conv_in.weight'), w('conv_in.bias'), padding=1)
    for i in range(levels):
        for j in range(layers):
            h = _res2d(p, w.sub(f'down_{i}_res_{j}'), h)
        if i != levels - 1:
            h = conv2d(p, F.pad(h, (0, 0, 0, 1, 0, 1)),
                       w(f'down_{i}_downsample.weight'),
                       w(f'down_{i}_downsample.bias'), stride=2)
    h = _res2d(p, w.sub('mid_res_1'), h)
    h = _vae_attn(p, w.sub('mid_attn'), h)
    h = _res2d(p, w.sub('mid_res_2'), h)
    h = silu(group_norm(h, w('conv_norm_out.weight'), w('conv_norm_out.bias'),
                        eps=1e-6))
    h = conv2d(p, h, w('conv_out.weight'), w('conv_out.bias'), padding=1)
    return conv2d(p, h, w('quant_conv.weight'), w('quant_conv.bias'))


def _spatio_temporal(p, w, x):
    """SVD SpatioTemporalResBlock on [B, F, H, W, C]: spatial block per
    frame, temporal block per video, blended by sigmoid(mix_factor)."""
    b, f, hh, ww, c = x.shape
    hs = _res2d(p, w.sub('spatial_res_block'), x.reshape(b * f, hh, ww, c))
    hs = hs.reshape(b, f, hh * ww, -1)
    t = w.sub('temporal_res_block')
    h = tconv3(p, silu(group_norm(hs, t('norm1.weight'), t('norm1.bias'))),
               t('conv1.weight'), t('conv1.bias'))
    h = tconv3(p, silu(group_norm(h, t('norm2.weight'), t('norm2.bias'))),
               t('conv2.weight'), t('conv2.bias'))
    ht = hs + h
    alpha = torch.sigmoid(w('mix_factor'))[0]
    out = (1.0 - alpha) * hs + alpha * ht
    return out.reshape(b, f, hh, ww, -1)


def vae_decode_window(p: Precision, w: Weights, z: torch.Tensor,
                      levels: int, layers: int) -> torch.Tensor:
    """Unscaled latents of one window [B, F, h, w, 4] -> [B, F, 8h, 8w, 3]
    (zero temporal padding at the window's edges)."""
    b, f, hh, ww, cz = z.shape
    x = conv2d(p, z.reshape(b * f, hh, ww, cz), w('conv_in.weight'),
               w('conv_in.bias'), padding=1).reshape(b, f, hh, ww, -1)
    x = _spatio_temporal(p, w.sub('mid_res_0'), x)
    x = _vae_attn(p, w.sub('mid_attn'), x.reshape(b * f, hh, ww, -1))
    x = _spatio_temporal(p, w.sub('mid_res_1'), x.reshape(b, f, hh, ww, -1))
    for i in range(levels):
        for j in range(layers + 1):
            x = _spatio_temporal(p, w.sub(f'up_{i}_res_{j}'), x)
        if i != levels - 1:
            _, _, h1, w1, c1 = x.shape
            up = F.interpolate(x.reshape(b * f, h1, w1, c1).permute(
                0, 3, 1, 2), scale_factor=2.0, mode='nearest')
            x = conv2d(p, up.permute(0, 2, 3, 1), w(f'up_{i}_upsample.weight'),
                       w(f'up_{i}_upsample.bias'), padding=1)
            x = x.reshape(b, f, 2 * h1, 2 * w1, c1)
    _, _, h2, w2, c2 = x.shape
    x4 = silu(group_norm(x.reshape(b * f, h2, w2, c2),
                         w('conv_norm_out.weight'), w('conv_norm_out.bias'),
                         eps=1e-6))
    x = conv2d(p, x4, w('conv_out.weight'), w('conv_out.bias'), padding=1)
    x = tconv3(p, x.reshape(b, f, h2 * w2, -1), w('time_conv_out.weight'),
               w('time_conv_out.bias'))
    return x.reshape(b, f, h2, w2, -1)


# ------------------------------------------------------------------ UNet
def sinusoidal(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.pow(10000.0, -torch.arange(half, dtype=torch.float32,
                                             device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _geglu(p, w, x):
    h, gate = linear(p, x, w('proj.weight'), w('proj.bias')).chunk(2, -1)
    return linear(p, h * F.gelu(gate, approximate='tanh'), w('out.weight'),
                  w('out.bias'))


def _attn(p, w, x, ctx, heads):
    q = linear(p, x, w('to_q.weight'))
    k = linear(p, ctx, w('to_k.weight'))
    v = linear(p, ctx, w('to_v.weight'))
    return linear(p, attention(p, q, k, v, heads), w('to_out.weight'),
                  w('to_out.bias'))


def _frame_attn(p, w, x, heads):
    """Attention over the frames of each pixel: x [B, F, N, C]."""
    b, f, n, c = x.shape
    fold = lambda t: t.permute(0, 2, 1, 3).reshape(b * n, f, -1)
    q = linear(p, x, w('to_q.weight'))
    k = linear(p, x, w('to_k.weight'))
    v = linear(p, x, w('to_v.weight'))
    a = attention(p, fold(q), fold(k), fold(v), heads)
    a = a.reshape(b, n, f, -1).permute(0, 2, 1, 3)
    return linear(p, a, w('to_out.weight'), w('to_out.bias'))


def _liem_gate(x, gw):
    """TemporalLIEM: sigmoid(w0 * max_c(x) + w1 * mean_c(x)) [..., 1]."""
    return torch.sigmoid(x.amax(-1, keepdim=True) * gw[0, 0]
                         + x.mean(-1, keepdim=True) * gw[0, 1])


def spatial_transformer(p, w, x, ctx, heads, split: bool):
    """x [BF, H, W, C]; with `split` x is one copy of the CFG pair and is
    tiled before the text cross-attention."""
    bf, hh, ww, c = x.shape
    x_in = x
    y = linear(p, group_norm(x, w('norm.weight'), w('norm.bias'),
                             eps=1e-6).reshape(bf, hh * ww, c),
               w('proj_in.weight'), w('proj_in.bias'))
    bl = w.sub('block')
    inner = y.shape[-1]
    ymap = y.reshape(bf, hh, ww, inner)
    g = torch.sigmoid(conv2d(p, torch.cat(
        [ymap.amax(-1, keepdim=True), ymap.mean(-1, keepdim=True)], -1),
        bl('local1.conv.weight'), padding=3)).reshape(bf, hh * ww, 1)
    n1 = layer_norm(g * y, bl('norm1.weight'), bl('norm1.bias'))
    y = _attn(p, bl.sub('attn1'), n1, n1, heads) + y
    if split:
        y, x_in = torch.cat([y, y]), torch.cat([x_in, x_in])
    n2 = layer_norm(y, bl('norm2.weight'), bl('norm2.bias'))
    y = _attn(p, bl.sub('attn2'), n2, ctx, heads) + y
    n3 = layer_norm(y, bl('norm3.weight'), bl('norm3.bias'))
    y = _geglu(p, bl.sub('ff'), n3) + y
    y = linear(p, y, w('proj_out.weight'), w('proj_out.bias'))
    return y.reshape(-1, hh, ww, c) + x_in


def temporal_transformer(p, w, x, heads):
    """x [B, F, H, W, C]."""
    b, f, hh, ww, c = x.shape
    y = linear(p, group_norm(x, w('norm.weight'), w('norm.bias'),
                             eps=1e-6).reshape(b, f, hh * ww, c),
               w('proj_in.weight'), w('proj_in.bias'))
    bl = w.sub('block')
    n1 = layer_norm(_liem_gate(y, bl('local1.proj.weight')) * y,
                    bl('norm1.weight'), bl('norm1.bias'))
    y = _frame_attn(p, bl.sub('attn1'), n1, heads) + y
    n2 = layer_norm(_liem_gate(y, bl('local2.proj.weight')) * y,
                    bl('norm2.weight'), bl('norm2.bias'))
    y = _frame_attn(p, bl.sub('attn2'), n2, heads) + y
    n3 = layer_norm(y, bl('norm3.weight'), bl('norm3.bias'))
    y = _geglu(p, bl.sub('ff'), n3) + y
    y = linear(p, y, w('proj_out.weight'), w('proj_out.bias'))
    return y.reshape(b, f, hh, ww, c) + x


def res_block(p, w, x, emb, frames):
    """x [BF, H, W, C], emb [BF, E] -> [BF, H, W, Cout]; then the
    four-stage temporal conv block with its residual."""
    h = conv2d(p, silu(group_norm(x, w('in_norm.weight'), w('in_norm.bias'))),
               w('in_conv.weight'), w('in_conv.bias'), padding=1)
    h = h + linear(p, silu(emb), w('emb_proj.weight'),
                   w('emb_proj.bias'))[:, None, None]
    h = conv2d(p, silu(group_norm(h, w('out_norm.weight'),
                                  w('out_norm.bias'))),
               w('out_conv.weight'), w('out_conv.bias'), padding=1)
    short = (conv2d(p, x, w('skip.weight'), w('skip.bias'))
             if w.has('skip.weight') else x)
    h = short + h
    bf, hh, ww, c = h.shape
    y = ident = h.reshape(bf // frames, frames, hh * ww, c)
    t = w.sub('temporal_conv')
    for n in ('conv1', 'conv2', 'conv3', 'conv4'):
        y = tconv3(p, silu(group_norm(y, t(f'{n}_norm.weight'),
                                      t(f'{n}_norm.bias'))),
                   t(f'{n}.weight'), t(f'{n}.bias'))
    return (y + ident).reshape(bf, hh, ww, c)


def unet_trunk(p: Precision, w: Weights, arch: dict, x, t, y, hint=None,
               controls=None, cfg_pair: bool = True):
    """The I2VGen-XL video UNet (controls given) or its ControlNet (hint
    given) on x [B, F, H, W, Cin]; y [2B, L, Cc] with cfg_pair (x, t and
    hint carry one copy of the pair, tiled at the first cross-attention).
    Returns v [2B, F, H, W, Cout], or the ControlNet's residuals."""
    b, f, hh, ww, cin = x.shape
    dim, hd = arch['dim'], arch['head_dim']
    mults, nres = arch['dim_mult'], arch['num_res_blocks']
    attn_scales = arch['attn_scales']
    is_control = hint is not None
    e = sinusoidal(t, dim)
    e = linear(p, e, w('time_embed_1.weight'), w('time_embed_1.bias'))
    e = linear(p, silu(e), w('time_embed_2.weight'), w('time_embed_2.bias'))
    e = e.repeat_interleave(f, dim=0)
    ctx = y.float().repeat_interleave(f, dim=0)
    state = {'split': cfg_pair, 'e': e}
    xs = []

    def spatial(name, h):
        heads = w(f'{name}.proj_in.weight').shape[0] // hd
        split = state['split']
        h = spatial_transformer(p, w.sub(name), h, ctx, heads, split)
        if split:
            state['split'] = False
            state['e'] = torch.cat([state['e'], state['e']])
            xs[:] = [torch.cat([s, s]) for s in xs]
        return h

    def temporal(name, h):
        heads = w(f'{name}.proj_in.weight').shape[0] // hd
        return temporal_transformer(p, w.sub(name), h.reshape(
            -1, f, *h.shape[1:]), heads).reshape(h.shape)

    def tap(h):
        if is_control:
            k = len(xs)
            xs.append(conv2d(p, h, w(f'zero_conv_{k}.weight'),
                             w(f'zero_conv_{k}.bias')))
        else:
            xs.append(h)

    h = conv2d(p, x.float().reshape(b * f, hh, ww, cin), w('conv_in.weight'),
               w('conv_in.bias'), padding=1)
    if is_control:
        h = h + conv2d(p, hint.float().reshape(b * f, hh, ww, -1),
                       w('input_hint.weight'), w('input_hint.bias'),
                       padding=1)
    h = temporal('init_temporal', h)
    tap(h)
    scale = 1.0
    for i in range(len(mults)):
        for j in range(nres):
            h = res_block(p, w.sub(f'enc_{i}_{j}_res'), h, state['e'], f)
            if scale in attn_scales:
                h = spatial(f'enc_{i}_{j}_spatial', h)
                h = temporal(f'enc_{i}_{j}_temporal', h)
            tap(h)
        if i != len(mults) - 1:
            h = conv2d(p, h, w(f'enc_{i}_down.conv.weight'),
                       w(f'enc_{i}_down.conv.bias'), stride=2,
                       padding=(2, 1))
            scale /= 2.0
            tap(h)
    h = res_block(p, w.sub('mid_res1'), h, state['e'], f)
    h = spatial('mid_spatial', h)
    h = temporal('mid_temporal', h)
    h = res_block(p, w.sub('mid_res2'), h, state['e'], f)
    if is_control:
        xs.append(conv2d(p, h, w('middle_out.weight'), w('middle_out.bias')))
        return xs

    controls = list(controls)
    h = h + controls.pop()
    for i in range(len(mults)):
        for j in range(nres + 1):
            skip = xs.pop() + controls.pop()
            h = res_block(p, w.sub(f'dec_{i}_{j}_res'),
                          torch.cat([h, skip], dim=-1), state['e'], f)
            if scale in attn_scales:
                h = spatial(f'dec_{i}_{j}_spatial', h)
                h = temporal(f'dec_{i}_{j}_temporal', h)
            if i != len(mults) - 1 and j == nres:
                up = F.interpolate(h.permute(0, 3, 1, 2), scale_factor=2.0,
                                   mode='nearest')[:, :, 1:-1]
                h = conv2d(p, up.permute(0, 2, 3, 1),
                           w(f'dec_{i}_up.conv.weight'),
                           w(f'dec_{i}_up.conv.bias'), padding=1)
                scale *= 2.0
    h = silu(group_norm(h, w('head_norm.weight'), w('head_norm.bias')))
    h = conv2d(p, h, w('head_conv.weight'), w('head_conv.bias'), padding=1)
    if state['split']:
        h = torch.cat([h, h])
    return h.reshape(-1, f, hh, ww, h.shape[-1])


def controlled_unet(p: Precision, w: Weights, arch: dict, x, t, y, hint):
    """UNet + ControlNet on the CFG pair: v [2B, F, H, W, 4]."""
    controls = unet_trunk(p, w.sub('controlnet'), arch, x, t, y, hint=hint)
    return unet_trunk(p, w.sub('unet'), arch, x, t, y, controls=controls)


def n_clip_blocks(layers: int, penultimate: bool) -> int:
    return layers - (1 if penultimate else 0)

