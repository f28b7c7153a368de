"""The port against the goldens dumped from the torch reference
(goldens/*.npz, the same files tests/test_golden_parity.py holds star_tpu
to, at the same tolerances). A golden's state dict goes through
star_tpu.convert's name maps into a flax tree, then through
convert/from_flax.py into the port — the path real weights take.
"""

import json
import os

import numpy as np
import pytest
import torch

from star_tpu_torch.convert import load_flax
from test_torch_harness import t

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), '..', 'goldens')


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _golden(name):
    path = os.path.join(GOLDEN_DIR, name)
    if not os.path.exists(path):
        pytest.skip(f'golden {name} not present')
    return np.load(path)


def _sd(data):
    return {k[4:]: data[k] for k in data.files if k.startswith('sd::')}


def test_unet_golden():
    from star_tpu.convert import controlled_unet_name_map, convert_state_dict
    from star_tpu_torch.models.unet.unet import ControlledV2VUNet
    data = _golden('unet_small.npz')
    cfg = json.loads(str(data['config_json']))
    map_cfg = dict(dim=cfg['dim'], dim_mult=tuple(cfg['dim_mult']),
                   num_res_blocks=cfg['num_res_blocks'],
                   attn_scales=tuple(cfg['attn_scales']))
    params = convert_state_dict(_sd(data), controlled_unet_name_map(**map_cfg))
    model = load_flax(ControlledV2VUNet(
        head_dim=cfg['head_dim'],
        num_heads_init_temporal=cfg['num_heads_init_temporal'],
        context_dim=cfg['context_dim'], **map_cfg), params).eval()
    to_ours = lambda a: t(np.transpose(a, (0, 2, 3, 4, 1)))
    with torch.no_grad():
        out = model(to_ours(data['x']), t(data['t']), t(data['y']),
                    to_ours(data['hint']))
    np.testing.assert_allclose(out.numpy(),
                               np.transpose(data['out'], (0, 2, 3, 4, 1)),
                               atol=5e-3)


def test_svd_vae_golden():
    from star_tpu.convert import convert_state_dict
    from star_tpu.convert.tower_maps import svd_vae_name_map
    from star_tpu_torch.vae.svd_vae import Encoder, TemporalDecoder
    data = _golden('svd_vae.npz')
    cfg = json.loads(str(data['config_json']))
    chs = tuple(cfg['block_out_channels'])
    layers = cfg['layers_per_block']
    params = convert_state_dict(_sd(data), svd_vae_name_map(
        block_out_channels=chs, layers_per_block=layers))
    to_ours = lambda a: np.transpose(a, (0, 2, 3, 1))
    enc = load_flax(Encoder(chs, layers), params['encoder']).eval()
    dec = load_flax(TemporalDecoder(chs, layers),
                    params['decoder']).eval()
    with torch.no_grad():
        moments = enc(t(to_ours(data['x'])))
        rec = dec(t(to_ours(data['z']))[None])
    np.testing.assert_allclose(moments.numpy(), to_ours(data['moments']),
                               atol=5e-3)
    np.testing.assert_allclose(rec.numpy()[0], to_ours(data['rec']),
                               atol=5e-3)


def test_clip_text_golden():
    from star_tpu.convert import convert_state_dict
    from star_tpu.convert.tower_maps import (clip_text_name_map,
                                             hf_clip_text_to_open_clip_sd)
    from star_tpu_torch.models.clip.text import CLIPTextEncoder
    data = _golden('clip_text.npz')
    cfg = json.loads(str(data['config_json']))
    params = convert_state_dict(
        hf_clip_text_to_open_clip_sd(_sd(data)),
        clip_text_name_map(layers=cfg['layers'], penultimate=True))
    model = load_flax(CLIPTextEncoder(
        vocab_size=cfg['vocab_size'], width=cfg['width'], heads=cfg['heads'],
        layers=cfg['layers'], context_length=cfg['context_length']),
        params).eval()
    with torch.no_grad():
        out = model(t(data['tokens']))
    np.testing.assert_allclose(out.numpy(), data['out'], atol=2e-4)


def test_sample_sr_golden():
    """The 15-step fast-mode DPM++(2M)-SDE trajectory (s_noise=0) of the
    reference's sample_sr with a closed-form denoiser: the 4+11 trailing
    ladder, sigma->t rounding, guide_rescale, both 2M update branches and
    the overlap-cut chunk stitching."""
    from star_tpu_torch.diffusion import (DiffusionTables, build_sigma_ladder,
                                          default_star_schedule,
                                          denoise_to_x0, sample_dpmpp_2m_sde)
    from star_tpu_torch.pipeline.chunking import chunked_x0_fn, make_chunks
    data = _golden('sample_sr.npz')
    schedule = default_star_schedule()
    tables = DiffusionTables.from_schedule(schedule)
    sigmas = build_sigma_ladder(schedule, steps=15, t_max=899, t_min=0,
                                solver_mode='fast', discretization='trailing')
    to_ours = lambda a: t(np.transpose(a, (0, 2, 3, 4, 1)))
    noised, hint = to_ours(data['noised']), to_ours(data['hint'])
    y_c, y_u = float(data['y_cond']), float(data['y_uncond'])

    def denoise_chunk(xt, hint_chunk, tt):
        tfull = torch.full((xt.shape[0],), tt)
        v = lambda y: torch.tanh(xt) * (tt / 1000.0) + y + 0.05 * hint_chunk
        return denoise_to_x0(tables, xt, tfull, v(y_c), v(y_u),
                             guide_scale=7.5, guide_rescale=0.2)

    chunk_inds = make_chunks(10, 4)
    assert chunk_inds == [tuple(p) for p in data['chunk_inds']]
    out = sample_dpmpp_2m_sde(chunked_x0_fn(denoise_chunk, hint, chunk_inds),
                              noised, schedule, sigmas, s_noise=0.0)
    np.testing.assert_allclose(out.numpy(),
                               np.transpose(data['out'], (0, 2, 3, 4, 1)),
                               atol=2e-4)
    out4 = sample_dpmpp_2m_sde(
        chunked_x0_fn(denoise_chunk, hint[:, :4], [(0, 4)]), noised[:, :4],
        schedule, sigmas, s_noise=0.0)
    np.testing.assert_allclose(
        out4.numpy(), np.transpose(data['out_nochunk'], (0, 2, 3, 4, 1)),
        atol=2e-4)
