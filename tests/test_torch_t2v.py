"""Stock CogVideoX text-to-video in the port (pipeline/cogvideo_t2v.py,
cli/sample_t2v.py, the stock DiT in pipeline/build.py and convert/load.py),
held against star_tpu:

  * the port's tiny CogVideoT2VPipeline.sample against star_tpu's own, on
    the stock DiT of tests/test_cogvideo_pipeline.py (hidden 64, 2 layers,
    4 heads, 4 latent channels, liem=False) with the small causal VAE and
    T5 of tests/test_torch_cog_pipeline.py, at 9 and 17 frames: the port is
    handed the initial noise and the per-step SDE noises that the JAX
    pipeline draws from its seed, so both compute the same function of the
    same numbers. uint8 within one level (a value on a rounding boundary
    may round either way in fp32), the final latents within 1e-4;
  * the same seed gives the same clip, another seed another, and a frame
    count that is not 4k+1 with k+1 odd raises;
  * sample_t2v.main --device cpu serves a stock DiT written with
    save_params (beside T5 and causal-VAE files) and gives the frames of
    the pipeline on the in-memory models; a LIEM dit.pt is refused with its
    extra keys named, and a stock one by the SR loader with its missing
    keys named;
  * init_random_cog_models(liem=False) builds the stock DiT;
  * the launches of one call of the full-depth DiT (42 layers), stock and
    SR, at narrow widths on tensors that answer is_cuda (the launchers
    counted, the plain versions refused): chip_smoke.py's
    LAUNCHES_PER_DIT_STEP, from which it asserts the text-to-video clip's
    50 calls exactly; K1 masks nothing where the stream is a whole number
    of 16-token rows, as the text-to-video clip's 17776 tokens are.
"""

import copy
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from star_tpu_torch.cli import sample_t2v
from star_tpu_torch.convert import load, save_params
from star_tpu_torch.data import io
from star_tpu_torch.models.dit.dit import CogVideoDiT
from star_tpu_torch.models.t5.encoder import T5Encoder
from star_tpu_torch.models.t5.tokenizer import T5HashTokenizer
from star_tpu_torch.pipeline import CogModelBundle, CogSamplerConfig
from star_tpu_torch.pipeline.cogvideo_t2v import CogVideoT2VPipeline
from star_tpu_torch.vae.causal_vae import CogVideoVAE
from test_torch_guards import _fake, _refuse
from test_torch_harness import port, random_params

CTX, TEXT_LEN, STEPS = 32, 8, 4
DIT_KW = dict(hidden_size=64, num_layers=2, num_heads=4, patch_size=2,
              latent_channels=4, text_hidden_size=CTX, text_length=TEXT_LEN,
              time_embed_dim=16)
VAE_KW = dict(ch=32, ch_mult=(1, 1, 1, 1), num_res_blocks=1, z_channels=4)
T5_KW = dict(vocab_size=100, d_model=CTX, d_ff=48, num_heads=2, num_layers=2)
HW = (32, 48)
LATENT_HW = (HW[0] // 8, HW[1] // 8)
PROMPT = 'a red cube rotating'


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    """One intra-op thread: the tensors are tiny, and a thread per core
    slows them when the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Tok(T5HashTokenizer):
    def __call__(self, texts, max_length=TEXT_LEN):
        return super().__call__(texts, max_length) % T5_KW['vocab_size']


@pytest.fixture(scope='module')
def pipes():
    """star_tpu's CogVideoT2VPipeline and the port's bundle on the same
    random weights."""
    from star_tpu.models.dit.dit import CogVideoDiT as JDiT
    from star_tpu.models.t5.encoder import T5Encoder as JT5
    from star_tpu.pipeline.cogvideo_sr import CogSamplerConfig as JCfg
    from star_tpu.pipeline.cogvideo_t2v import CogT2VBundle
    from star_tpu.pipeline.cogvideo_t2v import CogVideoT2VPipeline as JPipe
    from star_tpu.vae import causal_vae as jcv

    class TinyVAE(jcv.CogVideoVAE):
        def setup(self):
            self.encoder = jcv.CausalEncoder3D(**VAE_KW, name='encoder')
            self.decoder = jcv.CausalDecoder3D(**VAE_KW, name='decoder')

    dit, vae, t5 = JDiT(**DIT_KW, liem=False), TinyVAE(), JT5(**T5_KW)
    dp = random_params(dit, jnp.zeros((2, 3, *LATENT_HW, 4)),
                       jnp.zeros((2,), jnp.int32),
                       jnp.zeros((2, TEXT_LEN, CTX)), seed=81)
    vp = random_params(vae, jnp.zeros((1, 5, 16, 16, 3)), seed=82)
    tp = random_params(t5, jnp.zeros((1, TEXT_LEN), jnp.int32), seed=83)

    def vae_decode_window(p, latents, cache, first):
        variables = {'params': p['params'], **({'cache': cache} if cache
                                               else {})}
        out, mut = vae.apply(variables, latents, True, first,
                             method=TinyVAE.decode, mutable=['cache'])
        return out, mut['cache']

    jpipe = JPipe(CogT2VBundle(
        dit_apply=lambda p, x, t, c: dit.apply(p, x, t, c),
        vae_decode_window=vae_decode_window,
        text_encode=lambda p, tok: t5.apply(p, tok), tokenizer=Tok(),
        params={'dit': dp, 'vae': vp, 'text': tp}), JCfg(num_steps=STEPS),
        latent_hw=LATENT_HW, latent_channels=4)
    bundle = CogModelBundle(port(CogVideoDiT(**DIT_KW, liem=False), dp),
                            port(CogVideoVAE(**VAE_KW), vp),
                            port(T5Encoder(**T5_KW), tp), Tok())
    return jpipe, bundle


def port_pipe(bundle, steps=STEPS, **kw):
    return CogVideoT2VPipeline(bundle, CogSamplerConfig(num_steps=steps),
                               latent_hw=LATENT_HW, latent_channels=4,
                               device='cpu', **kw)


def jax_draws(seed, t_lat):
    """The numbers star_tpu's CogVideoT2VPipeline draws from its seed."""
    k_noise, k_solve = jax.random.split(jax.random.PRNGKey(seed))
    shape = (1, t_lat, *LATENT_HW, 4)
    keys = jax.random.split(k_solve, STEPS)
    as_t = lambda a: torch.from_numpy(np.array(a))
    return {'init': as_t(jax.random.normal(k_noise, shape, jnp.float32)),
            'sde': [as_t(jax.random.normal(keys[i], shape, jnp.float32))
                    for i in range(STEPS - 1)]}


@pytest.mark.parametrize('frames', [9, 17])
def test_sample_matches_star_tpu(pipes, frames):
    jpipe, bundle = pipes
    t_lat = (frames - 1) // 4 + 1
    want = jpipe.sample(PROMPT, num_frames=frames, seed=5)
    want_z = jpipe._run_cache[t_lat](
        jpipe.models.params, jpipe.encode_prompt(PROMPT),
        jpipe.encode_prompt(''), jax.random.PRNGKey(5))
    pipe = port_pipe(bundle, time_stages=True)
    got = pipe.sample(PROMPT, num_frames=frames, seed=5,
                      noise=jax_draws(5, t_lat))
    assert got.shape == want.shape == (frames, *HW, 3)
    assert got.dtype == np.uint8
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1, diff.max()
    assert got.std() > 0
    assert pipe.last_latents.shape == (1, t_lat, *LATENT_HW, 4)
    np.testing.assert_allclose(pipe.last_latents.numpy(), np.asarray(want_z),
                               rtol=0, atol=1e-4)
    assert set(pipe.stage_seconds) == {'text', 'denoise', 'vae_decode'}


def test_sample_is_seeded_and_checks_the_frame_count(pipes):
    _, bundle = pipes
    pipe = port_pipe(bundle, steps=2)
    a = pipe.sample(PROMPT, num_frames=9, seed=123)
    b = pipe.sample(PROMPT, num_frames=9, seed=123)
    c = pipe.sample(PROMPT, num_frames=9, seed=124)
    np.testing.assert_array_equal(a, b)
    assert np.abs(a.astype(int) - c.astype(int)).max() > 0
    assert pipe.stage_seconds == {}          # time_stages is off
    for f in (21, 8):       # 6 latents (even); not 4k+1
        with pytest.raises(ValueError, match='4k\\+1'):
            pipe.sample(PROMPT, num_frames=f)


TINY_TOWERS = {
    'dit': lambda liem: (lambda: CogVideoDiT(**DIT_KW, liem=liem)),
    't5': lambda liem: (lambda: T5Encoder(**T5_KW)),
    'causal_vae': lambda liem: (lambda: CogVideoVAE(**VAE_KW)),
}


@pytest.fixture
def tiny_towers(monkeypatch):
    """load.tower builds the tiny models (no name map: these files are the
    port's own state dicts)."""
    monkeypatch.setattr(load, 'tower', lambda kind, num_layers=None,
                        liem=True: (TINY_TOWERS[kind](liem), None))


def write_towers(root, bundle, dit=None):
    save_params(str(root / 'dit.pt'), (dit or bundle.dit).state_dict())
    save_params(str(root / 't5.pt'), bundle.text.state_dict())
    save_params(str(root / 'causal_vae.pt'), bundle.vae.state_dict())


def test_sample_t2v_main_serves_a_stock_dit_file(pipes, tiny_towers,
                                                 tmp_path, monkeypatch):
    """A stock DiT, T5 and causal VAE written with save_params ->
    sample_t2v.main --device cpu (bf16, as the CLI loads them): the frames
    of the pipeline on the same models in memory, bit for bit, saved
    through data/io.save_video."""
    _, bundle = pipes
    weights = tmp_path / 'weights'
    weights.mkdir()
    write_towers(weights, bundle)
    monkeypatch.setattr(sample_t2v, 'CogVideoT2VPipeline', functools.partial(
        CogVideoT2VPipeline, latent_hw=LATENT_HW, latent_channels=4))
    monkeypatch.setattr(sample_t2v, 'default_t5_tokenizer',
                        lambda allow_fallback: Tok())
    written = {}
    real_save = sample_t2v.save_video

    def save(frames, save_dir, name, fps=8):
        written[name] = frames
        return real_save(frames, save_dir, name, fps=fps)
    monkeypatch.setattr(sample_t2v, 'save_video', save)
    saved = sample_t2v.main([
        '--prompt', PROMPT, '--model_path', str(weights), '--num_frames',
        '9', '--num_steps', '2', '--seed', '7', '--save_dir',
        str(tmp_path / 'out'), '--device', 'cpu'])
    assert saved == [str(tmp_path / 'out' / 't2v.mp4')]
    back, fps = io.load_video(saved[0])
    assert back.shape == (9, *HW, 3) and fps == 8.0

    # copies: the cast must stay off the shared fixture's models
    bf16 = CogModelBundle(*(copy.deepcopy(m).to(torch.bfloat16) for m in (
        bundle.dit, bundle.vae, bundle.text)), Tok())
    want = port_pipe(bf16, steps=2).sample(PROMPT, num_frames=9, seed=7)
    np.testing.assert_array_equal(written['t2v.mp4'], want)


def test_dit_files_of_the_other_form_are_refused(pipes, tiny_towers,
                                                 tmp_path):
    _, bundle = pipes
    liem_dit = CogVideoDiT(**DIT_KW)
    write_towers(tmp_path, bundle, dit=liem_dit)
    with pytest.raises(RuntimeError, match='Unexpected key.*spa_local'):
        load.load_cog_models(str(tmp_path), device='cpu', liem=False)
    write_towers(tmp_path, bundle)
    with pytest.raises(RuntimeError, match='Missing key.*spa_local'):
        load.load_cog_models(str(tmp_path), device='cpu')
    stock = load.load_cog_models(str(tmp_path), dtype=torch.float32,
                                 device='cpu', liem=False)
    for a, b in zip(stock.dit.state_dict().values(),
                    bundle.dit.state_dict().values()):
        assert torch.equal(a, b)


def test_sample_t2v_main_needs_weights_or_the_random_flag(tmp_path):
    with pytest.raises(FileNotFoundError):
        sample_t2v.main(['--prompt', 'x', '--model_path',
                         str(tmp_path / 'none'), '--device', 'cpu'])


def test_init_random_cog_models_builds_the_stock_dit(monkeypatch):
    from star_tpu_torch.pipeline import build
    monkeypatch.setattr(build, 'CogVideoDiT', lambda liem: CogVideoDiT(
        **DIT_KW, liem=liem))
    monkeypatch.setattr(build, 'CogVideoVAE',
                        lambda: CogVideoVAE(**VAE_KW))
    class TinyT5(T5Encoder):      # a class: init_like_flax tests for it
        def __init__(self):
            super().__init__(**T5_KW)
    monkeypatch.setattr(build, 'T5Encoder', TinyT5)
    models = build.init_random_cog_models(dtype=torch.float32, device='cpu',
                                          liem=False)
    assert not models.dit.layers[0].liem
    assert models.dit.proj_sr.weight.shape[1] == 4    # Cz, no LQ concat
    assert not any('local' in k for k in models.dit.state_dict())
    sr = build.init_random_cog_models(dtype=torch.float32, device='cpu')
    assert sr.dit.layers[0].liem


@pytest.mark.parametrize('liem,grid,live', [
    (False, (13, 4, 10), 528),    # 8 + 520 tokens: 33 rows of 16, no tail
    (True, (7, 5, 15), 533)])     # 8 + 525 tokens carried as 544
def test_full_depth_dit_launches_per_call(monkeypatch, liem, grid, live):
    """At >= 512 tokens, where the DiT's attention takes K1."""
    import chip_smoke
    qr = importlib.import_module('star_tpu_torch.ops.qk_ln_rope')
    fa = importlib.import_module('star_tpu_torch.ops.flash_attention')
    fl = importlib.import_module('star_tpu_torch.ops.fused_ln')
    calls, kv_seen = [], set()
    for mod, plain in ((qr, 'qk_ln_rope_plain'), (fl, 'fused_ln_plain'),
                       (fa, 'flash_attention_packed_plain'),
                       (fa, 'attention_plain')):
        monkeypatch.setattr(mod, plain, _refuse)
    monkeypatch.setattr(fl, '_launch_ln', lambda x, *a: (
        calls.append('fused_ln'), x)[1])
    monkeypatch.setattr(qr, '_launch', lambda x, *a: (
        calls.append('qk_ln_rope'), x)[1])

    def k1(q, k, v, heads, d, c, kv, want_lse=False):
        calls.append('flash_packed')
        kv_seen.add(min(kv, k.shape[1]) if kv else k.shape[1])
        return q
    monkeypatch.setattr(fa, '_launch', k1)
    dit = CogVideoDiT(hidden_size=128, num_layers=42, num_heads=2,
                      patch_size=2, latent_channels=4, text_hidden_size=CTX,
                      text_length=TEXT_LEN, time_embed_dim=16, liem=liem)
    dit.requires_grad_(False)
    t_lat, hp, wp = grid
    cin = 4 * (2 if liem else 1)
    with torch.no_grad():
        out = dit(_fake(torch.randn(2, t_lat, 2 * hp, 2 * wp, cin)),
                  torch.tensor([499, 499]),
                  _fake(torch.randn(2, TEXT_LEN, CTX)))
    assert out.shape == (2, t_lat, 2 * hp, 2 * wp, 4)
    counts = {k: calls.count(k) for k in set(calls)}
    assert counts == chip_smoke.LAUNCHES_PER_DIT_STEP
    assert kv_seen == {live}
    assert chip_smoke.COG_PATH_LAUNCHES == {
        k: 50 * v for k, v in counts.items()}
