"""Name map: CogVideoX 3D VAE torch checkpoint -> the port's CogVideoVAE
(counterpart of star_tpu/convert/causal_vae_map.py).

Torch module tree (cp_enc_dec.py): every ContextParallelCausalConv3d wraps
its real conv as `.conv`; SpatialNorm3D holds `.norm_layer` + `.conv_y/.conv_b`
(1x1x1 causal convs); encoder levels are `down.{i}.block.{j}` + downsample,
decoder `up.{i}.block.{j}` + upsample (yaml: ch 128, mult [1,2,2,4], 3 res
blocks, z=16). The port's CausalConv3d holds the torch Conv3d layout, so
every tensor is copied as it is.
"""

from __future__ import annotations

from .unet_map import NameMap, _wb


def _causal(dst: str, src: str, m: NameMap):
    _wb(dst, f'{src}.conv', m)


def _spatial_norm(dst: str, src: str, m: NameMap):
    _wb(f'{dst}.norm', f'{src}.norm_layer', m)
    _causal(f'{dst}.conv_y', f'{src}.conv_y', m)
    _causal(f'{dst}.conv_b', f'{src}.conv_b', m)


def _resblock(dst: str, src: str, m: NameMap, in_c: int, out_c: int,
              spatial_norm: bool):
    norm = _spatial_norm if spatial_norm else _wb
    norm(f'{dst}.norm1', f'{src}.norm1', m)
    _causal(f'{dst}.conv1', f'{src}.conv1', m)
    norm(f'{dst}.norm2', f'{src}.norm2', m)
    _causal(f'{dst}.conv2', f'{src}.conv2', m)
    if in_c != out_c:
        # nin_shortcut is a plain Conv3d (not the causal wrapper)
        _wb(f'{dst}.nin_shortcut', f'{src}.nin_shortcut', m)


def causal_vae_name_map(ch: int = 128, ch_mult=(1, 2, 2, 4),
                        num_res_blocks: int = 3) -> NameMap:
    m = NameMap()
    chs = [ch * u for u in ch_mult]
    n_lv = len(ch_mult)

    # ---- encoder (plain GN norms)
    _causal('encoder.conv_in', 'encoder.conv_in', m)
    cur = ch
    for i in range(n_lv):
        for j in range(num_res_blocks):
            _resblock(f'encoder.down_{i}_block_{j}',
                      f'encoder.down.{i}.block.{j}', m, cur, chs[i], False)
            cur = chs[i]
        if i != n_lv - 1:
            _wb(f'encoder.down_{i}_downsample.conv',
                f'encoder.down.{i}.downsample.conv', m)
    _resblock('encoder.mid_block_1', 'encoder.mid.block_1', m, cur, cur, False)
    _resblock('encoder.mid_block_2', 'encoder.mid.block_2', m, cur, cur, False)
    _wb('encoder.norm_out', 'encoder.norm_out', m)
    _causal('encoder.conv_out', 'encoder.conv_out', m)

    # ---- decoder (SpatialNorm3D norms)
    _causal('decoder.conv_in', 'decoder.conv_in', m)
    cur = chs[-1]
    _resblock('decoder.mid_block_1', 'decoder.mid.block_1', m, cur, cur, True)
    _resblock('decoder.mid_block_2', 'decoder.mid.block_2', m, cur, cur, True)
    for i in reversed(range(n_lv)):
        for j in range(num_res_blocks + 1):
            _resblock(f'decoder.up_{i}_block_{j}', f'decoder.up.{i}.block.{j}',
                      m, cur, chs[i], True)
            cur = chs[i]
        if i != 0:
            _wb(f'decoder.up_{i}_upsample.conv',
                f'decoder.up.{i}.upsample.conv', m)
    _spatial_norm('decoder.norm_out', 'decoder.norm_out', m)
    _causal('decoder.conv_out', 'decoder.conv_out', m)
    return m
