"""The port's SVD VAE (encoder, windowed temporal decoder with the
AlphaBlender fold on and off, posterior sample) and CLIP text tower against
star_tpu's at tiny widths, with random non-zero parameters carried over
through convert/from_flax.py; fp32, tolerance 1e-4 of the reference
magnitude (test_torch_harness.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from star_tpu_torch.models.clip.text import CLIPTextEncoder
from star_tpu_torch.vae.svd_vae import SVDTemporalVAE
from test_torch_harness import (assert_close, port, random_params, randn,
                                rng, t)

VAE_CHS = (32, 32, 32, 32)


def jax_vae():
    from star_tpu.vae import svd_vae as jsv

    class TinyVAE(jsv.SVDTemporalVAE):
        def setup(self):
            self.encoder = jsv.Encoder(block_out_channels=VAE_CHS,
                                       name='encoder')
            self.decoder = jsv.TemporalDecoder(block_out_channels=VAE_CHS,
                                               layers_per_block=1,
                                               name='decoder')
    return TinyVAE()


@pytest.mark.parametrize('blend_fold', [True, False])
def test_svd_vae_matches_star_tpu(monkeypatch, blend_fold):
    monkeypatch.setenv('STAR_TPU_VAE_BLEND_FOLD', '1' if blend_fold else '0')
    jm = jax_vae()
    r = rng(9)
    video = randn(r, 1, 4, 32, 32, 3)
    params = random_params(jm, jnp.zeros((1, 2, 16, 16, 3)), seed=3)
    ours = port(SVDTemporalVAE(VAE_CHS, encoder_layers=2, decoder_layers=1,
                               blend_fold=blend_fold), params)
    want = jax.jit(lambda p, v: jm.apply(p, v, method=jm.encode_moments))(
        params, video)
    got = ours.encode_moments(t(video))
    assert_close(got, want)
    # 4 frames: one 3-frame window + a 1-frame remainder
    z = randn(r, 1, 4, 4, 4, 4, scale=0.2)
    want = jax.jit(lambda p, v: jm.apply(p, v, method=jm.decode))(params, z)
    got = ours.decode(t(z))
    assert got.shape == (1, 4, 32, 32, 3)
    assert_close(got, want)


def test_svd_vae_posterior_sample_uses_given_eps():
    ours = SVDTemporalVAE(VAE_CHS, decoder_layers=1).eval()
    r = rng(10)
    video = t(randn(r, 1, 2, 16, 16, 3))
    eps = t(randn(r, 1, 2, 2, 2, 4))
    with torch.no_grad():
        mean, logvar = ours.encode_moments(video).chunk(2, dim=-1)
        want = (mean + torch.exp(0.5 * logvar.clamp(-30, 20)) * eps) \
            * 0.18215
        got = ours.encode(video, eps=eps)
    assert_close(got, want)


def test_clip_text_matches_star_tpu():
    from star_tpu.models.clip.text import CLIPTextEncoder as JCLIP
    kw = dict(vocab_size=1000, width=32, heads=2, layers=3)
    jm = JCLIP(**kw)
    params = random_params(jm, jnp.zeros((1, 77), jnp.int32), seed=5)
    ours = port(CLIPTextEncoder(**kw), params)
    tokens = rng(11).randint(0, 1000, (2, 77)).astype(np.int32)
    assert_close(ours(t(tokens)), jax.jit(jm.apply)(params, tokens))


def test_tokenizers_match_star_tpu():
    from star_tpu.models.clip import tokenizer as jtok
    from star_tpu_torch.models.clip import tokenizer as ttok
    texts = ['a cat on a skateboard', 'Cinematic, High Contrast']
    np.testing.assert_array_equal(ttok.HashTokenizer()(texts),
                                  jtok.HashTokenizer()(texts))
    with pytest.raises(FileNotFoundError):
        ttok.default_tokenizer(bpe_path='/nonexistent.txt.gz')
