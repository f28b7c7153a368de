"""Plain float32 reference of STAR's CogVideoX-5B SR fine-tuning step
(cogvideox-based/sat: the DiT with LIEM and LoRA, T5-XXL, the causal 3D
VAE's encoder, SRDiffusionLoss's v-prediction loss, clip by global norm
and AdamW).

Weights are read by the program's state-dict names; the layout of the
q/k head dimension is the half-split RoPE basis those names hold. The
attention is exact softmax attention computed in blocks of rows, with a
backward of its own that recomputes each block (so that a 9680-token
layer fits), in float32 or the float8 control (prims.Precision).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .prims import Precision, Weights, conv2d, group_norm, layer_norm, linear

TRAINABLE = ('lora_a', 'lora_b', 'final_linear', 'final_adaln', 'final_ln',
             'proj_sr', 'spa_local', 'temp_local')
VAE_SCALE = 0.7


def is_trainable(name: str) -> bool:
    """LoRA, the final layer, proj_sr and the LIEM gates (the reference's
    disable_untrainable_params)."""
    return any(s in name for s in TRAINABLE)


# ------------------------------------------------------------------- T5
def t5_buckets(n: int, num_buckets: int = 32, max_distance: int = 128):
    rel = np.arange(n)[None, :] - np.arange(n)[:, None]
    nb = num_buckets // 2
    ret = (rel > 0).astype(np.int64) * nb
    a = np.abs(rel)
    exact = nb // 2
    large = exact + (np.log(np.maximum(a, 1) / exact)
                     / np.log(max_distance / exact)
                     * (nb - exact)).astype(np.int64)
    return ret + np.where(a < exact, a, np.minimum(large, nb - 1))


def _rms(x, scale, eps=1e-6):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def t5_encode(p: Precision, w: Weights, tokens: torch.Tensor, heads: int,
              layers: int) -> torch.Tensor:
    """T5 v1.1 encoder: RMSNorm pre-norm, unscaled attention with the
    shared relative position bias, gated-GELU feed-forward."""
    s = tokens.shape[1]
    x = w('token_embedding')[tokens.long()]
    idx = torch.from_numpy(t5_buckets(s)).to(tokens.device)
    bias = w('relative_attention_bias')[idx].permute(2, 0, 1)[None]
    for i in range(layers):
        b = w.sub(f'block_{i}')
        h = _rms(x, b('ln_attn.scale'))
        q, k, v = (linear(p, h, b(f'{n}.weight')) for n in 'qkv')
        x = x + linear(p, _attend(p, q, k, v, heads, 1.0, bias),
                       b('o.weight'))
        h = _rms(x, b('ln_mlp.scale'))
        g = F.gelu(linear(p, h, b('wi_0.weight')), approximate='tanh')
        x = x + linear(p, g * linear(p, h, b('wi_1.weight')),
                       b('wo.weight'))
    return _rms(x, w('final_norm.scale'))


def _attend(p, q, k, v, heads, scale, bias):
    bsz, s, c = q.shape
    d = c // heads
    split = lambda t: t.reshape(bsz, -1, heads, d).transpose(1, 2)
    logits = p.g(torch.matmul(p.q(split(q)),
                              p.q(split(k)).transpose(-1, -2)))
    probs = torch.softmax(logits * scale + bias, dim=-1)
    out = p.g(torch.matmul(p.q(probs), p.q(split(v))))
    return out.transpose(1, 2).reshape(bsz, s, c)


# ------------------------------------------------------------ causal VAE
def _cconv(p, x, weight, bias):
    """Causal 3D conv on [B, T, H, W, C]: frame 0 repeated kt-1 times in
    front, SAME padding in space."""
    kt, kh, kw = weight.shape[2:]
    if kt > 1:
        x = torch.cat([x[:, :1].expand(-1, kt - 1, -1, -1, -1), x], dim=1)
    y = p.g(F.conv3d(p.q(x).permute(0, 4, 1, 2, 3), p.q(weight), bias, 1,
                     (0, kh // 2, kw // 2)))
    return y.permute(0, 2, 3, 4, 1)


def _res3d(p, w, x):
    h = F.silu(group_norm(x, w('norm1.weight'), w('norm1.bias'), eps=1e-6))
    h = _cconv(p, h, w('conv1.weight'), w('conv1.bias'))
    h = F.silu(group_norm(h, w('norm2.weight'), w('norm2.bias'), eps=1e-6))
    h = _cconv(p, h, w('conv2.weight'), w('conv2.bias'))
    if w.has('nin_shortcut.weight'):
        x = _cconv(p, x, w('nin_shortcut.weight'), w('nin_shortcut.bias'))
    return x + h


def causal_vae_encode_moments(p: Precision, w: Weights, x: torch.Tensor,
                              levels: int, blocks: int,
                              time_levels: int = 2) -> torch.Tensor:
    """[B, T, H, W, 3] -> moments [B, (T-1)/4+1, H/8, W/8, 2z]."""
    h = _cconv(p, x, w('conv_in.weight'), w('conv_in.bias'))
    for i in range(levels):
        for j in range(blocks):
            h = _res3d(p, w.sub(f'down_{i}_block_{j}'), h)
        if i == levels - 1:
            continue
        b, t, hh, ww, c = h.shape
        if i < time_levels and t > 1:      # average frame pairs
            if t % 2:
                rest = h[:, 1:].reshape(b, t // 2, 2, hh, ww, c).mean(2)
                h = torch.cat([h[:, :1], rest], dim=1)
            else:
                h = h.reshape(b, t // 2, 2, hh, ww, c).mean(2)
            t = h.shape[1]
        hf = F.pad(h.reshape(b * t, hh, ww, c), (0, 0, 0, 1, 0, 1))
        h = conv2d(p, hf, w(f'down_{i}_downsample.conv.weight'),
                   w(f'down_{i}_downsample.conv.bias'), stride=2)
        h = h.reshape(b, t, hh // 2, ww // 2, -1)
    h = _res3d(p, w.sub('mid_block_1'), h)
    h = _res3d(p, w.sub('mid_block_2'), h)
    h = F.silu(group_norm(h, w('norm_out.weight'), w('norm_out.bias'),
                          eps=1e-6))
    return _cconv(p, h, w('conv_out.weight'), w('conv_out.bias'))


# ------------------------------------------------------------ attention
class BlockAttention(torch.autograd.Function):
    """softmax(q k^T * scale) v per head, q/k/v [B, H, S, D], computed in
    blocks of query rows; the backward recomputes each block's
    probabilities from the saved log-sum-exp (exact, float32)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, prec, rows):
        out = torch.empty_like(q)
        lse = torch.empty(q.shape[:-1], dtype=q.dtype, device=q.device)
        kq, vq = prec.q(k), prec.q(v)
        for i in range(0, q.shape[2], rows):
            s = torch.matmul(prec.q(q[:, :, i:i + rows]),
                             kq.transpose(-1, -2)) * scale
            m = torch.logsumexp(s, dim=-1, keepdim=True)
            out[:, :, i:i + rows] = torch.matmul(prec.q(torch.exp(s - m)),
                                                 vq)
            lse[:, :, i:i + rows] = m[..., 0]
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.prec, ctx.rows = scale, prec, rows
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        scale, pr, rows = ctx.scale, ctx.prec, ctx.rows
        dq = torch.empty_like(q)
        dk, dv = torch.zeros_like(k), torch.zeros_like(v)
        kq, vq = pr.q(k), pr.q(v)
        dsum = (do * out).sum(-1, keepdim=True)
        for i in range(0, q.shape[2], rows):
            sl = slice(i, i + rows)
            qb, dob = pr.q(q[:, :, sl]), pr.qg(do[:, :, sl])
            pb = torch.exp(torch.matmul(qb, kq.transpose(-1, -2)) * scale
                           - lse[:, :, sl, None])
            dv += torch.matmul(pr.q(pb).transpose(-1, -2), dob)
            dp = torch.matmul(dob, vq.transpose(-1, -2))
            ds = pr.qg(pb * (dp - dsum[:, :, sl]) * scale)
            dq[:, :, sl] = torch.matmul(ds, kq)
            dk += torch.matmul(ds.transpose(-1, -2), qb)
        return dq, dk, dv, None, None, None


def block_attention(p: Precision, q, k, v, heads: int, scale: float,
                    budget: int = 1 << 27):
    """q/k/v [B, S, H*D] -> [B, S, H*D]."""
    bsz, s, c = q.shape
    split = lambda t: t.reshape(bsz, s, heads, c // heads).transpose(1, 2)
    rows = max(1, min(s, budget // (bsz * heads * s)))
    out = BlockAttention.apply(split(q), split(k), split(v), scale, p, rows)
    return out.transpose(1, 2).reshape(bsz, s, c)


# ------------------------------------------------------------------ DiT
def rope_tables(tl: int, t: int, hp: int, wp: int, hd: int, device):
    """(cos, sin) [tl + t*hp*wp, hd]: identity at the text rows, the 3D
    RoPE (hd/4 dims for time, 3hd/8 each for height and width, each
    frequency twice) at the image rows, in the half-split basis."""
    def freqs(dim):
        return 1.0 / (10000.0 ** (np.arange(0, dim, 2)[: dim // 2] / dim))
    dt, dh = hd // 4, hd // 8 * 3
    rep = lambda a: np.repeat(a, 2, axis=-1)
    ft = rep(np.outer(np.arange(t), freqs(dt)))
    fh = rep(np.outer(np.arange(hp), freqs(dh)))
    fw = rep(np.outer(np.arange(wp), freqs(dh)))
    full = np.concatenate([
        np.broadcast_to(ft[:, None, None], (t, hp, wp, dt)),
        np.broadcast_to(fh[None, :, None], (t, hp, wp, dh)),
        np.broadcast_to(fw[None, None, :], (t, hp, wp, dh))], -1)
    full = full.reshape(-1, hd)[:, np.concatenate([np.arange(0, hd, 2),
                                                   np.arange(1, hd, 2)])]
    cos = np.concatenate([np.ones((tl, hd)), np.cos(full)])
    sin = np.concatenate([np.zeros((tl, hd)), np.sin(full)])
    as_t = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
    return as_t(cos), as_t(sin)


def _qk(x, scale, bias, cos, sin, heads):
    """Per-head LayerNorm (eps 1e-6) then the half-split rotation."""
    b, s, c = x.shape
    d = c // heads
    y = F.layer_norm(x.reshape(b, s, heads, d), (d,), scale, bias, 1e-6)
    rot = torch.cat([-y[..., d // 2:], y[..., :d // 2]], dim=-1)
    y = y * cos[None, :, None] + rot * sin[None, :, None]
    return y.reshape(b, s, c)


def _lora_dense(p, w, x, parts):
    a = linear(p, x, w('lora_a.weight')) if w.has('lora_a.weight') else None
    base, bias = w('base.weight'), w('base.bias')
    n = base.shape[0] // parts
    outs = []
    for i in range(parts):
        rows = slice(i * n, (i + 1) * n)
        y = linear(p, x, base[rows], bias[rows])
        if a is not None:
            y = y + linear(p, a, w('lora_b.weight')[rows])
        outs.append(y)
    return outs


def _modulate(x, shift, scale):
    return x * (1.0 + scale[:, None]) + shift[:, None]


def dit_layer(p, w, h, emb_act, cos, sin, grid, heads, tl, liem,
              plain_attention=False):
    b, s, c = h.shape
    t, hp, wp = grid
    (sh_msa, sc_msa, g_msa, sh_mlp, sc_mlp, g_mlp, t_sh_msa, t_sc_msa,
     t_g_msa, t_sh_mlp, t_sc_mlp, t_g_mlp) = linear(
        p, emb_act, w('adaln.weight'), w('adaln.bias')).chunk(12, dim=-1)
    text, img = h[:, :tl], h[:, tl:]
    hn = layer_norm(h, w('input_ln_scale'), w('input_ln_bias'))
    img_in = _modulate(hn[:, tl:], sh_msa, sc_msa)
    text_in = _modulate(hn[:, :tl], t_sh_msa, t_sc_msa)
    if liem:
        x = img_in.reshape(b * t, hp, wp, c)
        g = conv2d(p, torch.cat([x.amax(-1, keepdim=True),
                                 x.mean(-1, keepdim=True)], -1),
                   w('spa_local.conv.weight'), padding=3)
        x = (torch.sigmoid(g) * x).reshape(b, t, hp, wp, c) \
            .permute(0, 2, 3, 1, 4).reshape(b * hp * wp, t, c)
        g = linear(p, torch.cat([x.amax(-1, keepdim=True),
                                 x.mean(-1, keepdim=True)], -1),
                   w('temp_local.proj.weight'))
        img_in = (torch.sigmoid(g) * x).reshape(b, hp, wp, t, c) \
            .permute(0, 3, 1, 2, 4).reshape(b, t * hp * wp, c)
    q, k, v = _lora_dense(p, w.sub('qkv'), torch.cat([text_in, img_in], 1),
                          3)
    q = _qk(q, w('q_ln_scale'), w('q_ln_bias'), cos, sin, heads)
    k = _qk(k, w('k_ln_scale'), w('k_ln_bias'), cos, sin, heads)
    scale = 1.0 / math.sqrt(c // heads)
    attn = (_attend(p, q, k, v, heads, scale, 0.0) if plain_attention
            else block_attention(p, q, k, v, heads, scale))
    attn = _lora_dense(p, w.sub('dense'), attn, 1)[0]
    text = text + t_g_msa[:, None] * attn[:, :tl]
    img = img + g_msa[:, None] * attn[:, tl:]
    pln = lambda x: layer_norm(x, w('post_ln_scale'), w('post_ln_bias'))
    m = torch.cat([_modulate(pln(text), t_sh_mlp, t_sc_mlp),
                   _modulate(pln(img), sh_mlp, sc_mlp)], dim=1)
    m = F.gelu(linear(p, m, w('mlp_fc.weight'), w('mlp_fc.bias')),
               approximate='tanh')
    m = linear(p, m, w('mlp_proj.weight'), w('mlp_proj.bias'))
    text = text + t_g_mlp[:, None] * m[:, :tl]
    img = img + g_mlp[:, None] * m[:, tl:]
    return torch.cat([text, img], dim=1)


def sinusoidal(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.pow(10000.0, -torch.arange(half, dtype=torch.float32,
                                             device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def dit_forward(p: Precision, w: Weights, arch: dict, x, t_idx, context,
                remat: bool = True,
                plain_attention: bool = False) -> torch.Tensor:
    """x [B, T, H, W, 2z] (noisy || LQ), t_idx [B], context [B, L, 4096]
    -> v [B, T, H, W, z]; with `remat` each layer is recomputed in the
    backward; `plain_attention` materialises the logits (for counting
    FLOPs on the meta device)."""
    b, t, hh, ww, cin = x.shape
    ps, c, heads = arch['patch_size'], arch['hidden_size'], arch['num_heads']
    tl, cz = arch['text_length'], arch['latent_channels']
    hp, wp = hh // ps, ww // ps
    e = linear(p, sinusoidal(t_idx, c), w('time_embed_1.weight'),
               w('time_embed_1.bias'))
    e = linear(p, F.silu(e), w('time_embed_2.weight'), w('time_embed_2.bias'))
    emb_act = F.silu(e)
    img = conv2d(p, x.reshape(b * t, hh, ww, cin), w('proj_sr.weight'),
                 w('proj_sr.bias'), stride=ps).reshape(b, t * hp * wp, c)
    h = torch.cat([linear(p, context, w('text_proj.weight'),
                          w('text_proj.bias')), img], dim=1)
    cos, sin = rope_tables(tl, t, hp, wp, c // heads, x.device)
    for i in range(arch['num_layers']):
        fn = lambda h, i=i: dit_layer(p, w.sub(f'layers.{i}'), h, emb_act,
                                      cos, sin, (t, hp, wp), heads, tl,
                                      arch['liem'], plain_attention)
        h = checkpoint(fn, h, use_reentrant=False) if remat and \
            torch.is_grad_enabled() else fn(h)
    h = layer_norm(h, w('pre_final_ln_scale'), w('pre_final_ln_bias'))
    h = layer_norm(h, w('final_ln_scale'), w('final_ln_bias'), eps=1e-6)
    shift, scale = linear(p, emb_act, w('final_adaln.weight'),
                          w('final_adaln.bias')).chunk(2, dim=-1)
    out = linear(p, _modulate(h[:, tl:], shift, scale),
                 w('final_linear.weight'), w('final_linear.bias'))
    out = out.reshape(b, t, hp, wp, cz, ps, ps).permute(0, 1, 2, 5, 3, 6, 4)
    return out.reshape(b, t, hh, ww, cz)


# ------------------------------------------------------------ the step
def sqrt_alphas(n: int = 1000) -> np.ndarray:
    """sqrt(alpha-bar) of the linear-beta DDPM schedule (0.00085 to
    0.012), rescaled so that the last is 0 (zero terminal SNR); index ==
    timestep."""
    betas = np.linspace(0.00085 ** 0.5, 0.012 ** 0.5, n) ** 2
    s = np.sqrt(np.cumprod(1.0 - betas))
    return (s - s[-1]) * (s[0] / (s[0] - s[-1]))


def sr_loss(p: Precision, w: Weights, arch: dict, gt, lq, y, idx, noise,
            table: torch.Tensor) -> torch.Tensor:
    """SRDiffusionLoss: noised = a gt + sqrt(1 - a^2) eps, the LQ latent
    concatenated, x0_hat from the v-prediction, mean(w (x0_hat - gt)^2)
    with w = 1 / (1 - a^2)."""
    a = table[idx].reshape(-1, 1, 1, 1, 1)
    sigma = torch.sqrt(1.0 - a * a)
    noised = a * gt + sigma * noise
    v = dit_forward(p, w, arch, torch.cat([noised, lq], dim=-1), idx, y)
    x0 = -sigma * v + a * noised
    return torch.mean((x0 - gt) ** 2 / (1.0 - a * a))


def train(p: Precision, sd: dict, arch: dict, opt: dict, batches: list,
          on_step=None) -> list[float]:
    """AdamW over the float32 masters of the trainable set, each step's
    gradient clipped to opt['max_grad_norm'] by its global norm. `sd`
    holds the DiT's weights (float32, program names, 'dit.' prefix);
    batches: dicts of gt, lq (scaled latents), y, idx, noise.
    on_step(step, masters, grads) after each step (grads as the optimizer
    took them). Returns the losses."""
    names = [n for n in sd if n.startswith('dit.') and is_trainable(n)]
    masters = {n: sd[n].clone().requires_grad_(True) for n in names}
    live = dict(sd)
    live.update(masters)
    w = Weights(live, 'dit.')
    adamw = torch.optim.AdamW(list(masters.values()), lr=opt['lr'],
                              betas=(opt['beta1'], opt['beta2']),
                              eps=opt['eps'],
                              weight_decay=opt['weight_decay'])
    table = torch.tensor(sqrt_alphas(), dtype=torch.float32,
                         device=batches[0]['gt'].device)
    losses = []
    for step, bt in enumerate(batches, 1):
        loss = sr_loss(p, w, arch, bt['gt'], bt['lq'], bt['y'], bt['idx'],
                       bt['noise'], table)
        loss.backward()
        with torch.no_grad():
            norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(m.grad) for m in masters.values()]))
            factor = min(1.0, opt['max_grad_norm'] / float(norm))
            for m in masters.values():
                m.grad.mul_(factor)
            grads = {n: m.grad.clone() for n, m in masters.items()}
        adamw.step()
        adamw.zero_grad(set_to_none=True)
        losses.append(float(loss.detach()))
        if on_step is not None:
            on_step(step, masters, grads)
    return losses
