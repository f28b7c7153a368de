"""The port's checkpoint conversion (star_tpu_torch/convert/: name maps,
convert_state_dict, the torch files of load.py and cli.py) against
star_tpu.convert followed by convert/from_flax.py, the route real weights
took before it:

  * random non-zero reference-named state dicts of every tower at small
    configs (UNet+ControlNet at two attention layouts, the SVD VAE, CLIP
    in open_clip and HF naming, T5, the DiT with LoRA pairs merged and the
    RoPE head permutation, the causal VAE) convert to the same tensors,
    key for key and bit for bit in fp32;
  * at full width, on the meta device, each map covers every parameter of
    its port module exactly once, and reads the reference keys the JAX
    package's map reads;
  * merge_sat_lora and hf_clip_text_to_open_clip_sd equal star_tpu's;
  * a missing, unused or misshapen key raises;
  * convert.cli writes files that load_star_models / load_cog_models load
    (the towers cut to small configs);
  * every golden (goldens/*.npz) through the port's convert alone, with no
    star_tpu import (tests/test_torch_guards.py checks this by AST), gives
    today's outputs at today's tolerances (test_golden_parity.py's).

The reference-named dicts are made by chip_smoke.to_reference, the inverse
of a port map that chip_smoke.py uses for its round trips on the card, so
that inverse is held here too. star_tpu is imported inside the tests that
compare with it.
"""

import argparse
import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from star_tpu_torch.convert import (convert_state_dict, from_flax,
                                    load_params, nest, save_params)
from star_tpu_torch.convert import cli, load
from star_tpu_torch.convert.causal_vae_map import causal_vae_name_map
from star_tpu_torch.convert.tower_maps import (clip_text_name_map,
                                               convert_dit, dit_name_map,
                                               hf_clip_text_to_open_clip_sd,
                                               merge_sat_lora,
                                               svd_vae_name_map,
                                               t5_encoder_name_map)
from star_tpu_torch.convert.unet_map import controlled_unet_name_map
from star_tpu_torch.models.clip.text import CLIPTextEncoder
from star_tpu_torch.models.dit.dit import CogVideoDiT
from star_tpu_torch.models.t5.encoder import T5Encoder
from star_tpu_torch.models.unet.unet import ControlledV2VUNet
from star_tpu_torch.vae.causal_vae import (CausalDecoder3D, CausalEncoder3D,
                                           CogVideoVAE)
from star_tpu_torch.vae.svd_vae import SVDTemporalVAE

CPU = torch.device('cpu')
GOLDENS = os.path.join(os.path.dirname(__file__), '..', 'goldens')

UNET_MAP = dict(dim=32, dim_mult=(1, 2), num_res_blocks=1,
                attn_scales=(1.0, 0.5))
UNET_KW = dict(head_dim=16, num_heads_init_temporal=2, context_dim=32)
# the first stage without transformers, the second with them
UNET_MAP_HALF = dict(UNET_MAP, attn_scales=(0.5,))
VAE_CHS, VAE_LAYERS = (32, 64), 2
CLIP_KW = dict(vocab_size=100, width=32, heads=2, layers=3)
T5_KW = dict(vocab_size=120, d_model=64, d_ff=96, num_heads=4, num_layers=2)
DIT_KW = dict(hidden_size=128, num_layers=2, num_heads=2, patch_size=2,
              latent_channels=4, text_hidden_size=32, text_length=7,
              time_embed_dim=16)
CVAE_MAP = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1)

# kind -> (small port module, its port map); the towers of load.tower cut
# to the sizes above
SMALL = {
    'unet': (lambda: ControlledV2VUNet(**UNET_MAP, **UNET_KW),
             lambda: controlled_unet_name_map(**UNET_MAP)),
    'vae': (lambda: SVDTemporalVAE(VAE_CHS, VAE_LAYERS, VAE_LAYERS),
            lambda: svd_vae_name_map(VAE_CHS, VAE_LAYERS)),
    'clip': (lambda: CLIPTextEncoder(**CLIP_KW),
             lambda: clip_text_name_map(CLIP_KW['layers'])),
    't5': (lambda: T5Encoder(**T5_KW),
           lambda: t5_encoder_name_map(T5_KW['num_layers'])),
    'dit': (lambda: CogVideoDiT(**DIT_KW),
            lambda: dit_name_map(DIT_KW['num_layers'], DIT_KW['num_heads'])),
    'causal_vae': (lambda: CogVideoVAE(**CVAE_MAP, z_channels=4),
                   lambda: causal_vae_name_map(**CVAE_MAP)),
}


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    """One intra-op thread: these tensors are tiny, and torch's default of
    a thread per core slowed the tiny pipelines tenfold when the suite's
    workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reference_sd(build, name_map, seed):
    """A random reference-named fp32 state dict for the port module
    build() (non-zero everywhere: std 0.5 about 0.1)."""
    r = np.random.RandomState(seed)
    with torch.device('meta'):
        shapes = chip_smoke.to_reference(name_map, build().state_dict())
    return {k: torch.from_numpy(
        (0.1 + 0.5 * r.standard_normal(tuple(v.shape))).astype(np.float32))
        for k, v in sorted(shapes.items())}


def assert_same(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k].contiguous(), want[k]), k


def star_tpu_route(kind, sd, module, name_map_kw):
    """star_tpu.convert's name map into a flax tree, then from_flax."""
    from star_tpu.convert import convert_state_dict as jconvert
    from star_tpu.convert import causal_vae_map as jcv
    from star_tpu.convert import tower_maps as jtm
    from star_tpu.convert import unet_map as jum
    arrays = {k: v.numpy() for k, v in sd.items()}
    if kind == 'dit':
        tree = jtm.convert_dit(arrays, num_layers=DIT_KW['num_layers'],
                               num_heads=DIT_KW['num_heads'])
    else:
        jmap = {'unet': jum.controlled_unet_name_map,
                'vae': jtm.svd_vae_name_map,
                'clip': jtm.clip_text_name_map,
                't5': jtm.t5_encoder_name_map,
                'causal_vae': jcv.causal_vae_name_map}[kind](**name_map_kw)
        tree = jconvert(arrays, jmap)
    return from_flax(module, tree)


JAX_MAP_KW = {'unet': UNET_MAP, 'vae': dict(block_out_channels=VAE_CHS,
                                            layers_per_block=VAE_LAYERS),
              'clip': dict(layers=CLIP_KW['layers']),
              't5': dict(num_layers=T5_KW['num_layers']), 'dit': {},
              'causal_vae': CVAE_MAP}


@pytest.mark.parametrize('kind', ['unet', 'unet_half_attention', 'vae',
                                  'clip', 't5', 'causal_vae'])
def test_conversion_equals_star_tpu_then_from_flax(kind):
    if kind == 'unet_half_attention':
        kind, build = 'unet', lambda: ControlledV2VUNet(**UNET_MAP_HALF,
                                                        **UNET_KW)
        name_map, jkw = controlled_unet_name_map(**UNET_MAP_HALF), \
            UNET_MAP_HALF
    else:
        build, name_map = SMALL[kind][0], SMALL[kind][1]()
        jkw = JAX_MAP_KW[kind]
    module = build()
    sd = reference_sd(build, name_map, seed=len(name_map))
    got = convert_state_dict(sd, name_map, module)
    assert_same(got, star_tpu_route(kind, sd, module, jkw))


def test_clip_in_hf_naming_equals_star_tpu():
    """An HF CLIPTextModel state dict (q/k/v apart, HF names, the
    position_ids buffer) through both hf_clip_text_to_open_clip_sd's and
    both conversions."""
    from star_tpu.convert.tower_maps import \
        hf_clip_text_to_open_clip_sd as jhf
    build, name_map = SMALL['clip'][0], SMALL['clip'][1]()
    oc = reference_sd(build, name_map, seed=3)
    layers = CLIP_KW['layers']
    r = np.random.RandomState(4)
    for part, shape in (('weight', (96, 32)), ('bias', (96,))):
        oc[f'transformer.resblocks.{layers - 1}.attn.in_proj_{part}'] = \
            torch.from_numpy(r.standard_normal(shape).astype(np.float32))
    hf = {'text_model.embeddings.token_embedding.weight':
          oc['token_embedding.weight'],
          'text_model.embeddings.position_embedding.weight':
          oc['positional_embedding'],
          'text_model.embeddings.position_ids': torch.arange(16)[None],
          'text_model.final_layer_norm.weight': oc['ln_final.weight'],
          'text_model.final_layer_norm.bias': oc['ln_final.bias']}
    renames = (('ln_1.', 'layer_norm1.'), ('ln_2.', 'layer_norm2.'),
               ('mlp.c_fc.', 'mlp.fc1.'), ('mlp.c_proj.', 'mlp.fc2.'),
               ('attn.out_proj.', 'self_attn.out_proj.'))
    for i in range(layers):
        pre = f'transformer.resblocks.{i}.'
        for k, v in oc.items():
            if not k.startswith(pre) or 'in_proj' in k:
                continue
            rest = k[len(pre):]
            for a, b in renames:
                rest = rest.replace(a, b)
            hf[f'text_model.encoder.layers.{i}.{rest}'] = v
        for part in ('weight', 'bias'):
            q, k, v = oc.get(f'{pre}attn.in_proj_{part}').chunk(3)
            for name, t in zip('qkv', (q, k, v)):
                hf[f'text_model.encoder.layers.{i}.self_attn.{name}_proj.'
                   f'{part}'] = t
    ours = hf_clip_text_to_open_clip_sd(hf)
    theirs = jhf({k: v.numpy() for k, v in hf.items()})
    assert set(ours) == set(theirs)
    for k in theirs:
        np.testing.assert_array_equal(ours[k].numpy(), theirs[k])
    module = build()
    assert_same(convert_state_dict(ours, name_map, module),
                star_tpu_route('clip', ours, module, JAX_MAP_KW['clip']))


def lora_pairs(sd, rank, seed):
    """Add SAT lora2 matrix_A/matrix_B pairs on every layer's qkv and
    dense projections."""
    r = np.random.RandomState(seed)
    out = dict(sd)
    for i in range(DIT_KW['num_layers']):
        for proj in ('query_key_value', 'dense'):
            base = f'transformer.layers.{i}.attention.{proj}'
            n_out, n_in = sd[f'{base}.weight'].shape
            out[f'{base}.matrix_A.0'] = torch.from_numpy(
                r.standard_normal((rank, n_in)).astype(np.float32) * 0.1)
            out[f'{base}.matrix_B.0'] = torch.from_numpy(
                r.standard_normal((n_out, rank)).astype(np.float32) * 0.1)
    return out


def test_dit_with_lora_merged_and_rope_permutation_equals_star_tpu():
    from star_tpu.convert.tower_maps import merge_sat_lora as jmerge
    build, name_map = SMALL['dit'][0], SMALL['dit'][1]()
    sd = lora_pairs(reference_sd(build, name_map, seed=5), rank=4, seed=6)
    ours = merge_sat_lora(sd)
    theirs = jmerge(sd)
    assert not any('matrix_' in k for k in ours)
    assert_same(ours, theirs)
    module = build()
    got = convert_dit(ours, module)
    assert_same(got, star_tpu_route('dit', ours, module, {}))
    # the permutation moved the q and k rows and left the v rows
    w = ours['transformer.layers.0.attention.query_key_value.weight']
    qkv = got['layers.0.qkv.base.weight']
    c = DIT_KW['hidden_size']
    assert not torch.equal(qkv[:2 * c], w[:2 * c])
    assert torch.equal(qkv[2 * c:], w[2 * c:])
    with pytest.raises(KeyError, match='no port parameter'):
        convert_dit(sd, module)       # LoRA pairs left unmerged


def test_merge_sat_lora_rejects_an_unpaired_weight():
    sd = {'a.query_key_value.weight': torch.zeros(4, 2),
          'a.query_key_value.matrix_A.0': torch.ones(1, 2)}
    with pytest.raises(KeyError, match='unpaired'):
        merge_sat_lora(sd)


@pytest.mark.parametrize('kind', load.KINDS)
def test_maps_cover_the_full_width_modules_exactly(kind):
    """On the meta device (no memory): the map's keys are the module's
    parameters, each reference key is read once, the inverse round trip
    fits every shape, and the reference keys are those the JAX package's
    map reads at the same size."""
    from star_tpu.convert import causal_vae_map as jcv
    from star_tpu.convert import tower_maps as jtm
    from star_tpu.convert import unet_map as jum
    build, name_map = load.tower(kind)
    module = load.on_meta(build)
    want = module.state_dict()
    assert set(name_map) == set(want)
    srcs = [src for src, _ in name_map.values()]
    assert len(srcs) == len(set(srcs))
    ref = chip_smoke.to_reference(name_map, want)
    out = convert_state_dict(ref, name_map, module)
    assert {k: tuple(v.shape) for k, v in out.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    if kind == 'dit':
        d = jtm.dit_name_map(42)
        jsrcs = {src for src, _ in d['top'].values()} | {
            src.format(i=i) for src, _ in d['per_layer'].values()
            for i in range(42)}
    else:
        jmap = {'unet': jum.controlled_unet_name_map,
                'vae': jtm.svd_vae_name_map, 'clip': jtm.clip_text_name_map,
                't5': jtm.t5_encoder_name_map,
                'causal_vae': jcv.causal_vae_name_map}[kind]()
        jsrcs = {src for src, _ in jmap.values()}
    assert set(srcs) == jsrcs


@pytest.mark.parametrize('kind', load.KINDS)
def test_chip_smokes_inverse_round_trips_every_tensor(kind):
    """chip_smoke.to_reference then convert_state_dict gives back each
    random port tensor bit for bit (the DiT's head permutation, K5's
    layout and the squeezed Conv1d included)."""
    build, name_map = SMALL[kind][0], SMALL[kind][1]()
    module = build()
    r = np.random.RandomState(11)
    want = {k: torch.from_numpy(r.standard_normal(tuple(v.shape))
                                .astype(np.float32))
            for k, v in module.state_dict().items()}
    ref = chip_smoke.to_reference(name_map, want)
    assert_same(convert_state_dict(ref, name_map, module), want)


def test_conversion_raises_on_missing_unused_and_misshapen_keys():
    build, name_map = SMALL['clip'][0], SMALL['clip'][1]()
    module = build()
    sd = reference_sd(build, name_map, seed=7)
    dropped = dict(sd)
    del dropped['ln_final.bias']
    with pytest.raises(KeyError, match='missing'):
        convert_state_dict(dropped, name_map, module)
    partial = convert_state_dict(dropped, name_map, module, strict=False)
    assert set(module.state_dict()) - set(partial) == {'ln_final.bias'}
    with pytest.raises(KeyError, match='no port parameter'):
        convert_state_dict({**sd, 'extra.weight': torch.ones(2)}, name_map,
                           module)
    # the ignored keys: the dropped last block, open_clip's image tower
    convert_state_dict({**sd, 'visual.proj': torch.ones(2), 'logit_scale':
                        torch.ones(()), 'transformer.resblocks.2.ln_1.weight':
                        torch.ones(32)}, name_map, module)
    bad = dict(sd)
    bad['ln_final.weight'] = torch.ones(31)
    with pytest.raises(ValueError, match='ln_final.weight'):
        convert_state_dict(bad, name_map, module)
    with pytest.raises(KeyError, match='does not fit'):
        convert_state_dict(sd, name_map, CLIPTextEncoder(
            **{**CLIP_KW, 'layers': 4}))


def test_layouts_refuse_other_kernels():
    from star_tpu_torch.convert import layout
    with pytest.raises(ValueError, match='Conv3d'):
        layout.conv3d_t11_kernel(torch.ones(4, 3, 3, 3, 3))
    with pytest.raises(ValueError, match='Conv1d'):
        layout.conv1d_as_linear(torch.ones(4, 3, 3))


def test_conversion_keeps_dtype_and_copies_nothing_where_layouts_agree():
    build, name_map = SMALL['unet'][0], SMALL['unet'][1]()
    sd = {k: v.to(torch.bfloat16)
          for k, v in reference_sd(build, name_map, seed=8).items()}
    out = convert_state_dict(sd, name_map, load.on_meta(build))
    assert all(v.dtype == torch.bfloat16 for v in out.values())
    src = name_map['unet.conv_in.weight'][0]
    assert out['unet.conv_in.weight'].data_ptr() == sd[src].data_ptr()
    tconv = 'unet.enc_0_0_res.temporal_conv.conv1.weight'
    assert out[tconv].shape == (3, 1, 32, 32)
    np.testing.assert_array_equal(
        out[tconv].float().numpy(),
        sd[name_map[tconv][0]].float().numpy()[:, :, :, 0, 0]
        .transpose(2, 1, 0)[:, None])


@pytest.fixture
def small_towers(monkeypatch):
    monkeypatch.setattr(load, 'tower', lambda kind, num_layers=None,
                        liem=True: (SMALL[kind][0], SMALL[kind][1]()))


def test_cli_files_load_into_the_bundles(small_towers, tmp_path, capsys):
    """Each kind: a reference checkpoint (the unet's wrapped in
    'state_dict', the DiT's with LoRA pairs) -> convert.cli -> {kind}.pt
    -> load_star_models / load_cog_models on the CPU, equal to a direct
    conversion, in the dtype asked for."""
    expected = {}
    for i, kind in enumerate(load.KINDS):
        build, name_map = SMALL[kind][0], SMALL[kind][1]()
        sd = reference_sd(build, name_map, seed=20 + i)
        saved = {'state_dict': sd} if kind == 'unet' else sd
        args = []
        if kind == 'dit':
            saved, args = lora_pairs(sd, 2, 9), ['--merge-lora']
            sd = merge_sat_lora(saved)
        torch.save(saved, tmp_path / f'ref_{kind}.pt')
        cli.main([kind, str(tmp_path / f'ref_{kind}.pt'),
                  str(tmp_path / f'{kind}.pt')] + args)
        expected[kind] = convert_state_dict(sd, name_map, build())
    assert 'converted unet' in capsys.readouterr().out
    star = load.load_star_models(str(tmp_path), dtype=torch.float32,
                                 device='cpu')
    cog = load.load_cog_models(str(tmp_path), dtype=torch.bfloat16,
                               device='cpu')
    f32, bf16 = torch.float32, torch.bfloat16
    for kind, model, dtype in (
            ('unet', star.unet, f32), ('vae', star.vae, f32),
            ('clip', star.text, f32), ('dit', cog.dit, bf16),
            ('t5', cog.text, bf16), ('causal_vae', cog.vae, bf16)):
        assert not model.training
        assert not any(p.requires_grad for p in model.parameters())
        assert_same(model.state_dict(),
                    {k: v.to(dtype) for k, v in expected[kind].items()})


def test_load_params_says_what_weights_only_refused(tmp_path):
    path = tmp_path / 'ckpt.pt'
    torch.save({'module': {'w': torch.ones(2)},
                'args': argparse.Namespace(lr=1)}, path)
    with pytest.raises(ValueError, match='Namespace'):
        load_params(str(path))


def test_convert_cli_trust_pickle_reads_what_weights_only_refuses(
        small_towers, tmp_path):
    """A checkpoint with an argparse.Namespace beside its wrapped weights,
    as the JAX converter loads it (weights_only=False): refused by default,
    the refusal naming --trust-pickle; converted with it, equal to the
    conversion of the bare state dict."""
    build, name_map = SMALL['vae'][0], SMALL['vae'][1]()
    sd = reference_sd(build, name_map, seed=31)
    src, dst = tmp_path / 'ckpt.pt', tmp_path / 'vae.pt'
    torch.save({'module': sd, 'args': argparse.Namespace(lr=1)}, src)
    with pytest.raises(ValueError, match='Namespace.*--trust-pickle'):
        cli.main(['vae', str(src), str(dst)])
    assert not dst.exists()
    cli.main(['vae', str(src), str(dst), '--trust-pickle'])
    assert_same(load_params(str(dst)),
                convert_state_dict(sd, name_map, build()))


def test_save_params_writes_a_view_without_its_storage(tmp_path):
    big = torch.arange(1000.0)
    save_params(str(tmp_path / 'a.pt'), {'w': big[:4]})
    assert os.path.getsize(tmp_path / 'a.pt') < 2000
    assert torch.equal(load_params(str(tmp_path / 'a.pt'))['w'], big[:4])


def test_nest_matches_star_tpu():
    from star_tpu.convert import nest as jnest
    flat = {'a/b/c': 1, 'a/b/d': 2, 'a/e': 3, 'f': 4}
    assert nest(flat) == jnest(flat) == {'a': {'b': {'c': 1, 'd': 2},
                                                'e': 3}, 'f': 4}


# ------------------------------------------------------------------ goldens
# Each golden's state dict through the port's own maps, with no star_tpu
# import (checked by tests/test_torch_guards.py); the models are built on
# the meta device and take the converted tensors, as load.py does.


def _golden(name):
    path = os.path.join(GOLDENS, name)
    if not os.path.exists(path):
        pytest.skip(f'golden {name} not present')
    data = np.load(path)
    sd = {k[4:]: torch.from_numpy(data[k]) for k in data.files
          if k.startswith('sd::')}
    return data, sd, json.loads(str(data['config_json']))


def _port_model(build, sd, name_map):
    state = convert_state_dict(sd, name_map, load.on_meta(build))
    return load.module_from_state_dict(build, state, torch.float32, CPU)


def test_unet_golden_through_the_port_alone():
    data, sd, cfg = _golden('unet_small.npz')
    map_cfg = dict(dim=cfg['dim'], dim_mult=tuple(cfg['dim_mult']),
                   num_res_blocks=cfg['num_res_blocks'],
                   attn_scales=tuple(cfg['attn_scales']))
    model = _port_model(lambda: ControlledV2VUNet(
        head_dim=cfg['head_dim'],
        num_heads_init_temporal=cfg['num_heads_init_temporal'],
        context_dim=cfg['context_dim'], **map_cfg), sd,
        controlled_unet_name_map(**map_cfg))
    ours = lambda a: torch.from_numpy(np.transpose(a, (0, 2, 3, 4, 1)))
    with torch.no_grad():
        out = model(ours(data['x']), torch.from_numpy(data['t']),
                    torch.from_numpy(data['y']), ours(data['hint']))
    np.testing.assert_allclose(out.numpy(),
                               np.transpose(data['out'], (0, 2, 3, 4, 1)),
                               atol=5e-3)


def test_svd_vae_golden_through_the_port_alone():
    data, sd, cfg = _golden('svd_vae.npz')
    chs, layers = tuple(cfg['block_out_channels']), cfg['layers_per_block']
    vae = _port_model(lambda: SVDTemporalVAE(chs, layers, layers), sd,
                      svd_vae_name_map(chs, layers))
    ours = lambda a: torch.from_numpy(np.transpose(a, (0, 2, 3, 1)))
    with torch.no_grad():
        moments = vae.encoder(ours(data['x']))
        rec = vae.decoder(ours(data['z'])[None])
    np.testing.assert_allclose(moments.numpy(),
                               np.transpose(data['moments'], (0, 2, 3, 1)),
                               atol=5e-3)
    np.testing.assert_allclose(rec.numpy()[0],
                               np.transpose(data['rec'], (0, 2, 3, 1)),
                               atol=5e-3)


def test_clip_text_golden_through_the_port_alone():
    data, sd, cfg = _golden('clip_text.npz')
    model = _port_model(lambda: CLIPTextEncoder(
        vocab_size=cfg['vocab_size'], width=cfg['width'], heads=cfg['heads'],
        layers=cfg['layers'], context_length=cfg['context_length']),
        hf_clip_text_to_open_clip_sd(sd),
        clip_text_name_map(layers=cfg['layers'], penultimate=True))
    with torch.no_grad():
        out = model(torch.from_numpy(data['tokens']))
    np.testing.assert_allclose(out.numpy(), data['out'], atol=2e-4)


def test_t5_golden_through_the_port_alone():
    data, sd, cfg = _golden('t5_small.npz')
    model = _port_model(lambda: T5Encoder(
        vocab_size=cfg['vocab_size'], d_model=cfg['d_model'],
        d_ff=cfg['d_ff'], num_heads=cfg['num_heads'],
        num_layers=cfg['num_layers'], rel_buckets=cfg['rel_buckets'],
        rel_max_distance=cfg['rel_max_distance']), sd,
        t5_encoder_name_map(num_layers=cfg['num_layers']))
    with torch.no_grad():
        out = model(torch.from_numpy(np.asarray(data['tokens'])))
    np.testing.assert_allclose(out.numpy(), data['out'], atol=2e-4)


def test_dit_golden_through_the_port_alone():
    data, sd, cfg = _golden('dit_small.npz')
    build = lambda: CogVideoDiT(
        hidden_size=cfg['hidden_size'], num_layers=cfg['num_layers'],
        num_heads=cfg['num_attention_heads'], patch_size=cfg['patch_size'],
        latent_channels=cfg['in_channels'],
        text_hidden_size=cfg['text_hidden_size'],
        text_length=cfg['text_length'], time_embed_dim=cfg['time_embed_dim'])
    state = convert_dit(sd, load.on_meta(build))
    model = load.module_from_state_dict(build, state, torch.float32, CPU)
    ours = lambda a: torch.from_numpy(np.transpose(a, (0, 1, 3, 4, 2)))
    with torch.no_grad():
        out = model(ours(data['x']),
                    torch.from_numpy(np.asarray(data['timesteps'])),
                    torch.from_numpy(data['context']))
    np.testing.assert_allclose(out.numpy(),
                               np.transpose(data['out'], (0, 1, 3, 4, 2)),
                               atol=5e-3)


def test_causal_vae_golden_through_the_port_alone():
    data, sd, cfg = _golden('causal_vae.npz')
    kw = dict(ch=cfg['ch'], ch_mult=tuple(cfg['ch_mult']),
              num_res_blocks=cfg['num_res_blocks'])
    state = convert_state_dict(sd, causal_vae_name_map(**kw), load.on_meta(
        lambda: CogVideoVAE(**kw, z_channels=cfg['z_channels'])))
    kw.update(z_channels=cfg['z_channels'],
              temporal_compress_level=cfg['temporal_compress_level'])
    enc = load.module_from_state_dict(
        lambda: CausalEncoder3D(**kw),
        {k[8:]: v for k, v in state.items() if k.startswith('encoder.')},
        torch.float32, CPU)
    dec = load.module_from_state_dict(
        lambda: CausalDecoder3D(**kw),
        {k[8:]: v for k, v in state.items() if k.startswith('decoder.')},
        torch.float32, CPU)
    ours = lambda a: torch.from_numpy(np.transpose(a, (0, 2, 3, 4, 1)))
    with torch.no_grad():
        moments = enc(ours(data['x']))
        rec = dec(ours(data['z']))
    np.testing.assert_allclose(moments.numpy(),
                               np.transpose(data['moments'], (0, 2, 3, 4, 1)),
                               atol=5e-3)
    np.testing.assert_allclose(rec.numpy(),
                               np.transpose(data['rec'], (0, 2, 3, 4, 1)),
                               atol=5e-3)
