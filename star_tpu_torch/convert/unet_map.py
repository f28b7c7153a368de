"""Name map: reference ControlledV2VUNet torch state_dict -> the port's
ControlledV2VUNet state_dict (counterpart of star_tpu/convert/unet_map.py).

Torch module topology (unet_v2v.py): input_blocks[0]=[Conv2d, TemporalTx],
then per encoder stage i: two [ResBlock(+Spatial/Temporal Tx at attn scales)]
blocks and a Downsample (stages 0-2); middle_block=[Res, Spatial, Temporal,
Res]; output_blocks: 4 stages x 3 blocks (+Upsample at stage end, stages 0-2);
out=[GN, SiLU, Conv]. The ControlNet clone adds zero_convs[k],
middle_block_out and input_hint_block, all under the 'VideoControlNet.'
prefix of the combined state dict (unet_v2v.py:1712-1715).

The port's modules carry the JAX package's flax names, so a port key is the
flax path with '/' -> '.' and 'kernel' or 'scale' -> 'weight'; the layouts
are torch's, so every tensor is copied as it is except the (3,1,1) temporal
convs (K5's layout) and the Conv1d projections (squeezed; layout.py).
"""

from __future__ import annotations

import re
from typing import Callable, Iterable, Optional, Tuple

import torch

from .layout import conv1d_as_linear, conv3d_t11_kernel

# port state_dict key -> (reference key, layout function or None = as is)
Entry = Tuple[str, Optional[Callable[[torch.Tensor], torch.Tensor]]]


class NameMap(dict):
    """port key -> Entry. `ignore` holds regular expressions of the
    reference keys that the port has no parameter for (a tied copy, a
    buffer, a layer the port drops); any other reference key the map does
    not read is an error (convert.convert_state_dict)."""

    def __init__(self, entries=(), ignore: Iterable[str] = ()):
        super().__init__(entries)
        self.ignore = tuple(ignore)

    def ignores(self, key: str) -> bool:
        return any(re.fullmatch(p, key) for p in self.ignore)


def _attn_stages(dim_mult, attn_scales):
    """Which stages carry spatial+temporal transformers: the running scale
    starts at 1.0 and halves after each encoder downsample (unet_v2v.py:1335,
    1436); the decoder walks it back up."""
    enc = tuple((0.5 ** i) in tuple(attn_scales) for i in range(len(dim_mult)))
    return enc, enc[::-1]


def _wb(dst: str, src: str, m: NameMap, bias: bool = True, fn=None):
    """A layer's weight (through `fn`) and bias: Linear, Conv2d, Conv3d and
    every norm alike."""
    m[f'{dst}.weight'] = (f'{src}.weight', fn)
    if bias:
        m[f'{dst}.bias'] = (f'{src}.bias', None)


def _attention(dst: str, src: str, m: NameMap):
    _wb(f'{dst}.to_q', f'{src}.to_q', m, bias=False)
    _wb(f'{dst}.to_k', f'{src}.to_k', m, bias=False)
    _wb(f'{dst}.to_v', f'{src}.to_v', m, bias=False)
    _wb(f'{dst}.to_out', f'{src}.to_out.0', m)


def _block(dst: str, src: str, m: NameMap, spatial: bool):
    # BasicTransformerBlock: 'space' flavour (a 3x3 conv gate) or the
    # temporal one (two linear gates)
    if spatial:
        _wb(f'{dst}.local1.conv', f'{src}.local1.conv1', m, bias=False)
    else:
        _wb(f'{dst}.local1.proj', f'{src}.local1.conv1', m, bias=False)
        _wb(f'{dst}.local2.proj', f'{src}.local2.conv1', m, bias=False)
    _attention(f'{dst}.attn1', f'{src}.attn1', m)
    _attention(f'{dst}.attn2', f'{src}.attn2', m)
    for k in (1, 2, 3):
        _wb(f'{dst}.norm{k}', f'{src}.norm{k}', m)
    _wb(f'{dst}.ff.proj', f'{src}.ff.net.0.proj', m)
    _wb(f'{dst}.ff.out', f'{src}.ff.net.2', m)


def _spatial_tx(dst: str, src: str, m: NameMap):
    _wb(f'{dst}.norm', f'{src}.norm', m)
    _wb(f'{dst}.proj_in', f'{src}.proj_in', m)     # use_linear=True
    _wb(f'{dst}.proj_out', f'{src}.proj_out', m)
    _block(f'{dst}.block', f'{src}.transformer_blocks.0', m, spatial=True)


def _temporal_tx(dst: str, src: str, m: NameMap):
    _wb(f'{dst}.norm', f'{src}.norm', m)
    _wb(f'{dst}.proj_in', f'{src}.proj_in', m, fn=conv1d_as_linear)
    _wb(f'{dst}.proj_out', f'{src}.proj_out', m, fn=conv1d_as_linear)
    _block(f'{dst}.block', f'{src}.transformer_blocks.0', m, spatial=False)


def _temporal_conv(dst: str, src: str, m: NameMap):
    # TemporalConvBlock_v2: convK = Sequential(GN, SiLU, [Dropout,] Conv3d)
    for k, conv_idx in (('conv1', 2), ('conv2', 3), ('conv3', 3),
                        ('conv4', 3)):
        _wb(f'{dst}.{k}_norm', f'{src}.{k}.0', m)
        _wb(f'{dst}.{k}', f'{src}.{k}.{conv_idx}', m, fn=conv3d_t11_kernel)


def _res_block(dst: str, src: str, m: NameMap, has_skip: bool):
    _wb(f'{dst}.in_norm', f'{src}.in_layers.0', m)
    _wb(f'{dst}.in_conv', f'{src}.in_layers.2', m)
    _wb(f'{dst}.emb_proj', f'{src}.emb_layers.1', m)
    _wb(f'{dst}.out_norm', f'{src}.out_layers.0', m)
    _wb(f'{dst}.out_conv', f'{src}.out_layers.3', m)
    if has_skip:
        _wb(f'{dst}.skip', f'{src}.skip_connection', m)
    # note the reference's attribute spelling: 'temopral_conv'
    _temporal_conv(f'{dst}.temporal_conv', f'{src}.temopral_conv', m)


def trunk_name_map(is_controlnet: bool, dim: int = 320,
                   dim_mult=(1, 2, 4, 4), num_res_blocks: int = 2,
                   attn_scales=(1.0, 0.5, 0.25)) -> NameMap:
    """Map for one VideoUNetTrunk vs one torch Vid2VidSDUNet/VideoControlNet
    (state-dict names relative to the net, no 'VideoControlNet.' prefix)."""
    attn_enc, attn_dec = _attn_stages(dim_mult, attn_scales)
    m = NameMap()
    _wb('time_embed_1', 'time_embed.0', m)
    _wb('time_embed_2', 'time_embed.2', m)
    _wb('conv_in', 'input_blocks.0.0', m)
    _temporal_tx('init_temporal', 'input_blocks.0.1', m)
    if is_controlnet:
        _wb('input_hint', 'input_hint_block', m)

    enc_dims = [dim * u for u in (1,) + tuple(dim_mult)]
    blk = 1
    tap = 1  # zero_conv index (0 is the init block's)
    if is_controlnet:
        _wb('zero_conv_0', 'zero_convs.0.0', m)
    for i, (in_d, out_d) in enumerate(zip(enc_dims[:-1], enc_dims[1:])):
        for j in range(num_res_blocks):
            src = f'input_blocks.{blk}'
            _res_block(f'enc_{i}_{j}_res', f'{src}.0', m,
                       has_skip=(in_d if j == 0 else out_d) != out_d)
            if attn_enc[i]:
                _spatial_tx(f'enc_{i}_{j}_spatial', f'{src}.1', m)
                _temporal_tx(f'enc_{i}_{j}_temporal', f'{src}.2', m)
            if is_controlnet:
                _wb(f'zero_conv_{tap}', f'zero_convs.{tap}.0', m)
            blk += 1
            tap += 1
        if i != len(dim_mult) - 1:
            _wb(f'enc_{i}_down.conv', f'input_blocks.{blk}.op', m)
            if is_controlnet:
                _wb(f'zero_conv_{tap}', f'zero_convs.{tap}.0', m)
            blk += 1
            tap += 1

    _res_block('mid_res1', 'middle_block.0', m, has_skip=False)
    _spatial_tx('mid_spatial', 'middle_block.1', m)
    _temporal_tx('mid_temporal', 'middle_block.2', m)
    _res_block('mid_res2', 'middle_block.3', m, has_skip=False)
    if is_controlnet:
        _wb('middle_out', 'middle_block_out.0', m)
        return m

    # decoder (UNet only); every dec ResBlock sees concat input -> has skip
    blk = 0
    for i in range(len(dim_mult)):
        for j in range(num_res_blocks + 1):
            src = f'output_blocks.{blk}'
            _res_block(f'dec_{i}_{j}_res', f'{src}.0', m, has_skip=True)
            idx = 1
            if attn_dec[i]:
                _spatial_tx(f'dec_{i}_{j}_spatial', f'{src}.{idx}', m)
                _temporal_tx(f'dec_{i}_{j}_temporal', f'{src}.{idx + 1}', m)
                idx += 2
            if i != len(dim_mult) - 1 and j == num_res_blocks:
                _wb(f'dec_{i}_up.conv', f'{src}.{idx}.conv', m)
            blk += 1

    _wb('head_norm', 'out.0', m)
    _wb('head_conv', 'out.2', m)
    return m


def controlled_unet_name_map(**cfg) -> NameMap:
    """Full ControlledV2VUNet: 'unet.' from the top-level names,
    'controlnet.' from the 'VideoControlNet.' prefix. `cfg` forwards
    dim/dim_mult/num_res_blocks/attn_scales for scaled-down variants."""
    m = NameMap()
    for key, (src, fn) in trunk_name_map(False, **cfg).items():
        m[f'unet.{key}'] = (src, fn)
    for key, (src, fn) in trunk_name_map(True, **cfg).items():
        m[f'controlnet.{key}'] = (f'VideoControlNet.{src}', fn)
    return m
