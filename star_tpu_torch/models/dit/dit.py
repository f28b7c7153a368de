"""CogVideoX-5B DiT with STAR's SR modifications
(counterpart of star_tpu/models/dit/dit.py).

Defaults are the published config (cogvideox_5b_infer_sr.yaml): 42 layers,
hidden 3072, 48 heads of 64, patch 2, 16 latent channels (32 in: the
noisy latent channel-concatenated with the LQ latent), T5-XXL text 4096 ->
3072 with 226 tokens, time embed 512, adaLN-Zero with separate text/image
modulation, qk-LayerNorm, 3D RoPE on image tokens, LIEM gates on the
modulated attention input, final adaLN + unpatchify.

As in the JAX package: channels-last latents [B, T, H, W, C]; the residual
stream is carried padded to a multiple of 16 tokens with the dead tail
masked out of attention (kv_valid); the q/k prologue is K9 (qk_ln_rope),
with the softmax scale * log2(e) folded into q's LN affine so that K1 runs
prescaled; the stream's LayerNorms are K10 (fused_ln). The RoPE tables are
host numpy in the half-split basis; K9 takes them as [S, 64] rows
(identity at text and tail rows) instead of the JAX package's head-tiled
[S, H*64] copy. The JAX package scans one layer over stacked
parameters, rematerialised in the backward; here the layers are an
nn.ModuleList (`layers`), and convert/from_flax.py unstacks the scanned
tree into it. With `remat` (the default) and grad mode on, each layer runs
under torch.utils.checkpoint (non-reentrant): the backward recomputes it
from its saved input. Under no_grad the layers run as plain calls.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from torch.utils.checkpoint import checkpoint

from ...ops.attention import dot_product_attention_packed
from ...ops.fused_ln import fused_ln
from ...ops.qk_ln_rope import LOG2E, qk_ln_rope
from ...parallel.mesh import AXIS_CONTEXT, Mesh, collective
from ...parallel.sharding import copy_to_tp, reduce_from_tp
from ...parallel.ulysses import ulysses_attention
from ..layers import Conv2d, zero_
from ..unet.blocks import silu32, sinusoidal_embedding


def rope_head_perm(head_dim: int) -> np.ndarray:
    """Head-dim permutation taking the reference's interleaved RoPE pairs
    (2i, 2i+1) to half-split slots (i, i + hd/2). Attention logits are
    invariant under a permutation shared by q and k; converted checkpoints
    apply it to the q/k projections and the qk-LN parameters."""
    return np.concatenate([np.arange(0, head_dim, 2),
                           np.arange(1, head_dim, 2)])


def rope_3d_tables(t_size: int, height: int, width: int, head_dim: int,
                   theta: float = 10000.0) -> tuple[np.ndarray, np.ndarray]:
    """(cos, sin) [T*H*W, head_dim] of the 3D RoPE: head dims split
    t = hd/4, h = w = 3hd/8, each frequency repeated twice, permuted to the
    half-split basis."""
    dim_t = head_dim // 4
    dim_h = head_dim // 8 * 3
    dim_w = head_dim // 8 * 3

    def freqs(dim):
        return 1.0 / (theta ** (np.arange(0, dim, 2)[: dim // 2] / dim))

    rep2 = lambda a: np.repeat(a, 2, axis=-1)
    ft = rep2(np.outer(np.arange(t_size), freqs(dim_t)))
    fh = rep2(np.outer(np.arange(height), freqs(dim_h)))
    fw = rep2(np.outer(np.arange(width), freqs(dim_w)))
    full = np.concatenate([
        np.broadcast_to(ft[:, None, None, :], (t_size, height, width, dim_t)),
        np.broadcast_to(fh[None, :, None, :], (t_size, height, width, dim_h)),
        np.broadcast_to(fw[None, None, :, :], (t_size, height, width, dim_w)),
    ], axis=-1).reshape(t_size * height * width, head_dim)
    full = full[:, rope_head_perm(head_dim)]
    return np.cos(full), np.sin(full)


def rope_tables(text_length: int, t_size: int, height: int, width: int,
                s_pad: int, head_dim: int) -> tuple[np.ndarray, np.ndarray]:
    """Full-sequence (cos, sin) [s_pad, head_dim] fp32: the identity
    rotation at the text rows and the pad tail, the 3D RoPE between."""
    cos_np, sin_np = rope_3d_tables(t_size, height, width, head_dim)
    end = text_length + cos_np.shape[0]
    cos = np.ones((s_pad, head_dim), np.float32)
    sin = np.zeros((s_pad, head_dim), np.float32)
    cos[text_length:end] = cos_np
    sin[text_length:end] = sin_np
    return cos, sin


def modulate(x, shift, scale):
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


class SpatialLIEMTokens(nn.Module):
    """LIEM spatial gate on [BT, H, W, C]: channel max and mean -> 7x7 conv
    -> fp32 sigmoid, rounded to x.dtype, times x."""

    def __init__(self):
        super().__init__()
        self.conv = Conv2d(2, 1, 7, padding=3, bias=False)

    def forward(self, x):
        w = self.conv(torch.cat([torch.amax(x, dim=-1, keepdim=True),
                                 torch.mean(x, dim=-1, keepdim=True)], -1))
        return torch.sigmoid(w.float()).to(x.dtype) * x


class TemporalLIEMTokens(nn.Module):
    """LIEM temporal gate on [BHW, T, C]: channel max and mean -> 2->1
    dense -> fp32 sigmoid, rounded to x.dtype, times x."""

    def __init__(self):
        super().__init__()
        self.proj = nn.Linear(2, 1, bias=False)

    def forward(self, x):
        w = self.proj(torch.cat([torch.amax(x, dim=-1, keepdim=True),
                                 torch.mean(x, dim=-1, keepdim=True)], -1))
        return torch.sigmoid(w.float()).to(x.dtype) * x


class LoraDense(nn.Module):
    """Dense with an optional additive LoRA (lora_b zero-initialised).
    Split by parallel.shard_params, `tp_mode` is 'column' (base and lora_b
    hold this rank's output rows, lora_a whole) or 'row' (base and lora_a
    hold this rank's input features; their partial products are
    all-reduced over `tp_group`)."""

    def __init__(self, in_features: int, features: int, lora_rank: int = 0,
                 bias: bool = True):
        super().__init__()
        self.base = nn.Linear(in_features, features, bias=bias)
        self.lora_rank = lora_rank
        self.tp_mode, self.tp_group = None, None
        if lora_rank > 0:
            self.lora_a = nn.Linear(in_features, lora_rank, bias=False)
            self.lora_b = zero_(nn.Linear(lora_rank, features, bias=False))

    def forward(self, x: torch.Tensor, parts: int = 1):
        """The output, or with `parts` > 1 its `parts` equal column blocks,
        each computed from its own rows of the weights (contiguous, with
        the same values as splitting the whole output)."""
        a = self.lora_a(x) if self.lora_rank > 0 else None
        row = self.tp_mode == 'row'
        if self.tp_mode == 'column':
            x = copy_to_tp(x, self.tp_group)
            a = None if a is None else copy_to_tp(a, self.tp_group)
        n = self.base.out_features // parts
        outs = []
        for i in range(parts):
            rows = slice(i * n, (i + 1) * n)
            bias = None if self.base.bias is None else self.base.bias[rows]
            if row:
                y = reduce_from_tp(F.linear(x, self.base.weight[rows]),
                                   self.tp_group)
                y = y if bias is None else y + bias
            else:
                y = F.linear(x, self.base.weight[rows], bias)
            if a is not None:
                y = y + F.linear(a, self.lora_b.weight[rows])
            outs.append(y)
        return outs[0] if parts == 1 else tuple(outs)


class _GatherRows(torch.autograd.Function):
    """Every rank's rows [B, S/P, C] of a stream, concatenated along the
    rows on every rank; the gradient of a rank's rows is the sum of the
    ranks' gradients of them."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        collective(x, group)
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(
            group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        collective(g, ctx.group)
        dist.all_reduce(g, group=ctx.group)
        rows = g.shape[1] // dist.get_world_size(ctx.group)
        r = dist.get_rank(ctx.group)
        return g[:, r * rows:(r + 1) * rows], None


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _GatherRows.apply(x, group)


class DiTLayer(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int, text_length: int,
                 time_embed_dim: int, lora_rank: int = 0, liem: bool = True):
        super().__init__()
        c, hd = hidden_size, hidden_size // num_heads
        self.num_heads, self.text_length = num_heads, text_length
        self.liem = liem
        self.adaln = nn.Linear(time_embed_dim, 12 * c)
        for name in ('input_ln', 'post_ln'):
            setattr(self, f'{name}_scale', nn.Parameter(torch.ones(c)))
            setattr(self, f'{name}_bias', nn.Parameter(torch.zeros(c)))
        if liem:
            self.spa_local = SpatialLIEMTokens()
            self.temp_local = TemporalLIEMTokens()
        self.qkv = LoraDense(c, 3 * c, lora_rank)
        for name in ('q_ln', 'k_ln'):
            setattr(self, f'{name}_scale', nn.Parameter(torch.ones(hd)))
            setattr(self, f'{name}_bias', nn.Parameter(torch.zeros(hd)))
        self.dense = LoraDense(c, c, lora_rank)
        self.mlp_fc = nn.Linear(c, 4 * c)
        self.mlp_proj = nn.Linear(4 * c, c)

    def forward(self, h: torch.Tensor, emb_act: torch.Tensor,
                rope_cos: torch.Tensor, rope_sin: torch.Tensor,
                grid: tuple[int, int, int]) -> torch.Tensor:
        """h [B, S, C] (text rows, image rows, dead tail); emb_act the
        silu'd time embedding [B, E] in h.dtype; grid (T, H, W) of the
        image tokens."""
        b, s, c = h.shape
        tl, heads = self.text_length, self.num_heads
        t_size, hp, wp = grid
        n_img = t_size * hp * wp
        (sh_msa, sc_msa, g_msa, sh_mlp, sc_mlp, g_mlp, t_sh_msa, t_sc_msa,
         t_g_msa, t_sh_mlp, t_sc_mlp, t_g_mlp) = \
            self.adaln(emb_act).chunk(12, dim=-1)
        post_ln = lambda x: fused_ln(x, self.post_ln_scale,
                                     self.post_ln_bias, 1e-5)

        text, img = h[:, :tl], h[:, tl:]
        # input_ln is one K10 over the whole stream (rows are independent);
        # post_ln one per segment, since the gated residual adds below
        # leave text and image in tensors of their own
        hn = fused_ln(h, self.input_ln_scale, self.input_ln_bias, 1e-5)
        img_in = modulate(hn[:, tl:], sh_msa, sc_msa)
        text_in = modulate(hn[:, :tl], t_sh_msa, t_sc_msa)
        # the real image tokens are the first n_img rows; the dead tail
        # bypasses LIEM
        img_tail, img_in = img_in[:, n_img:], img_in[:, :n_img]
        if self.liem:
            spa = self.spa_local(img_in.reshape(b * t_size, hp, wp, c))
            tmp = spa.reshape(b, t_size, hp, wp, c).permute(0, 2, 3, 1, 4) \
                .reshape(b * hp * wp, t_size, c)
            tmp = self.temp_local(tmp)
            img_in = tmp.reshape(b, hp, wp, t_size, c) \
                .permute(0, 3, 1, 2, 4).reshape(b, n_img, c)
        attn_in = torch.cat([text_in, img_in, img_tail], dim=1)
        q, k, v = self.qkv(attn_in, parts=3)
        hd = q.shape[-1] // heads     # heads: this rank's, under TP
        q = qk_ln_rope(q, self.q_ln_scale, self.q_ln_bias, rope_cos, rope_sin,
                       heads, fold_scale=LOG2E / math.sqrt(hd))
        k = qk_ln_rope(k, self.k_ln_scale, self.k_ln_bias, rope_cos, rope_sin,
                       heads)
        valid = tl + n_img
        attn = dot_product_attention_packed(
            q, k, v, heads, kv_valid=valid if valid < s else None,
            prescaled=True)
        attn = self.dense(attn)
        text = text + t_g_msa[:, None, :] * attn[:, :tl]
        img = img + g_msa[:, None, :] * attn[:, tl:]

        img_m = modulate(post_ln(img), sh_mlp, sc_mlp)
        text_m = modulate(post_ln(text), t_sh_mlp, t_sc_mlp)
        hdn = self.mlp_fc(torch.cat([text_m, img_m], dim=1))
        hdn = F.gelu(hdn.float(), approximate='tanh').to(hdn.dtype)
        mlp = self.mlp_proj(hdn)
        text = text + t_g_mlp[:, None, :] * mlp[:, :tl]
        img = img + g_mlp[:, None, :] * mlp[:, tl:]
        return torch.cat([text, img], dim=1)


    def forward_sp(self, h: torch.Tensor, emb_act: torch.Tensor,
                   rope_cos: torch.Tensor, rope_sin: torch.Tensor,
                   grid: tuple[int, int, int], group,
                   offset: int) -> torch.Tensor:
        """The layer on this rank's rows h [B, S/P, C] of the padded
        stream, the rows offset, offset+1, ...; rope_cos/rope_sin are
        those rows' tables. Text rows take the text modulation, the
        others the image one, row by row."""
        b, s, c = h.shape
        tl, heads = self.text_length, self.num_heads
        t_size, hp, wp = grid
        n_img = t_size * hp * wp
        s_full = s * dist.get_world_size(group)
        (sh_msa, sc_msa, g_msa, sh_mlp, sc_mlp, g_mlp, t_sh_msa, t_sc_msa,
         t_g_msa, t_sh_mlp, t_sc_mlp, t_g_mlp) = \
            self.adaln(emb_act).chunk(12, dim=-1)
        text = (torch.arange(offset, offset + s, device=h.device)
                < tl)[None, :, None]
        pick = lambda a_t, a_i: torch.where(text, a_t[:, None, :],
                                            a_i[:, None, :])
        hn = fused_ln(h, self.input_ln_scale, self.input_ln_bias, 1e-5)
        attn_in = hn * (1.0 + pick(t_sc_msa, sc_msa)) + pick(t_sh_msa, sh_msa)
        if self.liem:
            full = gather_rows(attn_in, group)
            img = full[:, tl:tl + n_img]
            spa = self.spa_local(img.reshape(b * t_size, hp, wp, c))
            tmp = spa.reshape(b, t_size, hp, wp, c).permute(0, 2, 3, 1, 4) \
                .reshape(b * hp * wp, t_size, c)
            img = self.temp_local(tmp).reshape(b, hp, wp, t_size, c) \
                .permute(0, 3, 1, 2, 4).reshape(b, n_img, c)
            full = torch.cat([full[:, :tl], img, full[:, tl + n_img:]], 1)
            attn_in = full[:, offset:offset + s]
        q, k, v = self.qkv(attn_in, parts=3)
        hd = q.shape[-1] // heads
        q = qk_ln_rope(q, self.q_ln_scale, self.q_ln_bias, rope_cos, rope_sin,
                       heads, fold_scale=LOG2E / math.sqrt(hd))
        k = qk_ln_rope(k, self.k_ln_scale, self.k_ln_bias, rope_cos, rope_sin,
                       heads)
        to4 = lambda x: x.reshape(b, s, heads, hd)
        valid = tl + n_img
        attn = ulysses_attention(
            to4(q), to4(k), to4(v), group,
            kv_valid=valid if valid < s_full else None,
            prescaled=True).reshape(b, s, q.shape[-1])
        h = h + pick(t_g_msa, g_msa) * self.dense(attn)
        m = fused_ln(h, self.post_ln_scale, self.post_ln_bias, 1e-5)
        m = m * (1.0 + pick(t_sc_mlp, sc_mlp)) + pick(t_sh_mlp, sh_mlp)
        hdn = self.mlp_fc(m)
        hdn = F.gelu(hdn.float(), approximate='tanh').to(hdn.dtype)
        return h + pick(t_g_mlp, g_mlp) * self.mlp_proj(hdn)


class CogVideoDiT(nn.Module):
    """x [B, T, H, W, Cin] (noisy || LQ channel concat, Cin = 2 Cz; Cz alone
    for the stock model, liem=False), t_idx [B] int, context
    [B, text_length, text_hidden] -> v-prediction [B, T, H, W, Cz]."""

    def __init__(self, hidden_size: int = 3072, num_layers: int = 42,
                 num_heads: int = 48, patch_size: int = 2,
                 latent_channels: int = 16, text_hidden_size: int = 4096,
                 text_length: int = 226, time_embed_dim: int = 512,
                 lora_rank: int = 0, liem: bool = True, remat: bool = True,
                 sp_group=None):
        super().__init__()
        c, p = hidden_size, patch_size
        self.remat = remat
        self.sp_group = sp_group     # Ulysses SP over this group
        self.hidden_size, self.num_heads, self.patch_size = c, num_heads, p
        self.latent_channels, self.text_length = latent_channels, text_length
        in_channels = latent_channels * (2 if liem else 1)
        self.time_embed_1 = nn.Linear(c, time_embed_dim)
        self.time_embed_2 = nn.Linear(time_embed_dim, time_embed_dim)
        self.proj_sr = Conv2d(in_channels, c, p, stride=p)
        self.text_proj = nn.Linear(text_hidden_size, c)
        self.layers = nn.ModuleList(
            DiTLayer(c, num_heads, text_length, time_embed_dim, lora_rank,
                     liem)
            for _ in range(num_layers))
        for name in ('pre_final_ln', 'final_ln'):
            setattr(self, f'{name}_scale', nn.Parameter(torch.ones(c)))
            setattr(self, f'{name}_bias', nn.Parameter(torch.zeros(c)))
        self.final_adaln = nn.Linear(time_embed_dim, 2 * c)
        self.final_linear = nn.Linear(c, p * p * latent_channels)
        self._tables: dict = {}

    def rope(self, t: int, hp: int, wp: int, s_pad: int, device):
        """The [s_pad, head_dim] fp32 (cos, sin) tables on `device`, made
        once per shape."""
        key = (t, hp, wp, s_pad, str(device))
        if key not in self._tables:
            cos, sin = rope_tables(self.text_length, t, hp, wp, s_pad,
                                   self.hidden_size // self.num_heads)
            self._tables[key] = (torch.from_numpy(cos).to(device),
                                 torch.from_numpy(sin).to(device))
        return self._tables[key]

    def forward(self, x: torch.Tensor, t_idx: torch.Tensor,
                context: torch.Tensor) -> torch.Tensor:
        b, t, hh, ww, cin = x.shape
        p, c = self.patch_size, self.hidden_size
        hp, wp = hh // p, ww // p
        dtype = self.proj_sr.weight.dtype

        # timestep embedding in fp32 (the JAX package's fp32 dense layers)
        e = sinusoidal_embedding(t_idx, c)
        e = F.linear(e, self.time_embed_1.weight.float(),
                     self.time_embed_1.bias.float())
        e = F.linear(F.silu(e), self.time_embed_2.weight.float(),
                     self.time_embed_2.bias.float()).to(dtype)
        emb_act = silu32(e)

        emb = self.proj_sr(x.to(dtype).reshape(b * t, hh, ww, cin))
        emb = emb.reshape(b, t * hp * wp, c)
        text_emb = self.text_proj(context.to(dtype))
        h = torch.cat([text_emb, emb], dim=1)
        # the stream is carried at a multiple of 16 tokens (and of the SP
        # ranks); the layers mask the dead tail out of attention and it is
        # dropped at the end
        group = self.sp_group
        if isinstance(group, Mesh):
            group = group.group(AXIS_CONTEXT)
        n = 1 if group is None else dist.get_world_size(group)
        assert self.num_heads % n == 0, (
            f'Ulysses SP needs heads ({self.num_heads}) divisible by the '
            f'sequence-parallel size {n}')
        mult = 16 * n // math.gcd(16, n)
        s_real = self.text_length + t * hp * wp
        s_pad = -(-s_real // mult) * mult
        if s_pad != s_real:
            h = F.pad(h, (0, 0, 0, s_pad - s_real))
        cos, sin = self.rope(t, hp, wp, s_pad, x.device)
        grid = (t, hp, wp)
        if n > 1:      # this rank's rows
            rows = s_pad // n
            off = dist.get_rank(group) * rows
            h, cos, sin = (a[..., off:off + rows, :] for a in (h, cos, sin))
            run = lambda layer, h: layer.forward_sp(h, emb_act, cos, sin,
                                                    grid, group, off)
        else:
            run = lambda layer, h: layer(h, emb_act, cos, sin, grid)
        remat = self.remat and torch.is_grad_enabled()
        for layer in self.layers:
            h = checkpoint(run, layer, h, use_reentrant=False) if remat \
                else run(layer, h)

        # both final norms run over the whole stream (one K10 each) and the
        # image rows are taken after
        h = fused_ln(h, self.pre_final_ln_scale, self.pre_final_ln_bias, 1e-5)
        h = fused_ln(h, self.final_ln_scale, self.final_ln_bias, 1e-6)
        if n > 1:
            h = gather_rows(h, group)
        img = h[:, self.text_length:s_real]
        f_shift, f_scale = self.final_adaln(emb_act).chunk(2, dim=-1)
        img = self.final_linear(modulate(img, f_shift, f_scale))
        # unpatchify: [B, T*hp*wp, p*p*Cz] -> [B, T, H, W, Cz]
        cz = self.latent_channels
        img = img.reshape(b, t, hp, wp, cz, p, p).permute(0, 1, 2, 5, 3, 6, 4)
        return img.reshape(b, t, hh, ww, cz)
