"""Tiny sizes of the cells, for the CPU tests (not benchmark cells)."""

import copy
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))


def tiny_i2vgen() -> dict:
    with open(os.path.join(ROOT, 'benchmark', 'configs',
                           'i2vgen_xl_star.json')) as f:
        cfg = json.load(f)
    cfg = copy.deepcopy(cfg)
    cfg['unet'].update(dim=64, dim_mult=[1, 2], num_res_blocks=1,
                       attn_scales=[1.0, 0.5], head_dim=32,
                       num_heads_init_temporal=2, context_dim=64)
    cfg['vae'].update(block_out_channels=[32, 32, 64, 64])
    cfg['text'].update(width=64, heads=2, layers=3)
    cfg['pipeline'].update(pad_grid=[64, 96])
    return cfg


def tiny_sr_traffic() -> dict:
    return {'kind': 'sr_clips', 'clients': 1, 'loop': 'closed', 'frames': 8,
            'height': 16, 'width': 24, 'fps': 24.0, 'captions': 3,
            'caption_words': 5, 'max_clips': 3}


def tiny_cog() -> dict:
    with open(os.path.join(ROOT, 'benchmark', 'configs',
                           'cogvideox_5b_star.json')) as f:
        cfg = json.load(f)
    cfg['dit'].update(hidden_size=128, num_layers=2, num_heads=2,
                      text_hidden_size=64, text_length=16,
                      time_embed_dim=32)
    cfg['vae'].update(ch=32, num_res_blocks=1)
    cfg['text'].update(d_model=64, d_ff=128, num_heads=2, num_layers=2,
                       max_length=16)
    cfg['train'].update(lora_rank=8)
    return cfg


def tiny_train_traffic() -> dict:
    return {'kind': 'lora_train', 'loop': 'closed', 'pool': 4, 'frames': 9,
            'height': 64, 'width': 96, 'batch_size': 1}
