"""The port's T5 encoder, T5 tokenizer and conditioner
(star_tpu_torch/models/t5/, models/conditioner.py) against star_tpu's, at
tiny widths with random non-zero parameters carried over through
convert/from_flax.py, and against the t5_small golden at the JAX test's
atol 2e-4 (test_golden_parity.py). fp32, 1e-4 of the reference magnitude
(test_torch_harness.py).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from star_tpu_torch.convert import load_flax
from star_tpu_torch.models.conditioner import GeneralConditioner, TextEmbedder
from star_tpu_torch.models.t5.encoder import (T5Encoder,
                                              relative_position_buckets)
from star_tpu_torch.models.t5.tokenizer import (T5HashTokenizer,
                                                default_t5_tokenizer)
from test_torch_harness import assert_close, port, random_params, rng

KW = dict(vocab_size=120, d_model=64, d_ff=96, num_heads=4, num_layers=2)
GOLDEN = os.path.join(os.path.dirname(__file__), '..', 'goldens',
                      't5_small.npz')


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def t5():
    from star_tpu.models.t5.encoder import T5Encoder as JT5
    jm = JT5(**KW)
    params = random_params(jm, jnp.zeros((2, 12), jnp.int32), seed=50)
    return jm, params, port(T5Encoder(**KW), params)


def test_t5_matches_star_tpu(t5):
    jm, params, ours = t5
    tokens = rng(51).randint(0, KW['vocab_size'], (2, 12)).astype(np.int32)
    tokens[1, 7:] = 0                         # zero padding, no mask
    want = jax.jit(jm.apply)(params, jnp.asarray(tokens))
    got = ours(torch.from_numpy(tokens))
    assert got.shape == (2, 12, 64)
    assert_close(got, want)


def test_relative_position_buckets_match_star_tpu():
    from star_tpu.models.t5.encoder import relative_position_buckets as jb
    for q, k in ((226, 226), (13, 40)):
        np.testing.assert_array_equal(relative_position_buckets(q, k),
                                      jb(q, k))


def test_t5_golden():
    if not os.path.exists(GOLDEN):
        pytest.skip('golden t5_small.npz not present')
    from star_tpu.convert import convert_state_dict
    from star_tpu.convert.tower_maps import t5_encoder_name_map
    data = np.load(GOLDEN)
    cfg = json.loads(str(data['config_json']))
    sd = {k[4:]: data[k] for k in data.files if k.startswith('sd::')}
    params = convert_state_dict(
        sd, t5_encoder_name_map(num_layers=cfg['num_layers']))
    model = load_flax(T5Encoder(
        vocab_size=cfg['vocab_size'], d_model=cfg['d_model'],
        d_ff=cfg['d_ff'], num_heads=cfg['num_heads'],
        num_layers=cfg['num_layers'], rel_buckets=cfg['rel_buckets'],
        rel_max_distance=cfg['rel_max_distance']), params).eval()
    with torch.no_grad():
        out = model(torch.from_numpy(np.asarray(data['tokens'])))
    np.testing.assert_allclose(out.numpy(), data['out'], atol=2e-4)


def test_hash_tokenizer_ids_equal_star_tpus_in_one_process():
    from star_tpu.models.t5.tokenizer import T5HashTokenizer as JTok
    texts = ['a good video', '', 'Cinematic, High Contrast ' * 40]
    for max_length in (226, 8):
        ours = T5HashTokenizer()(texts, max_length)
        np.testing.assert_array_equal(ours, JTok()(texts, max_length))
        assert ours.dtype == np.int32 and ours.shape == (3, max_length)
    assert list(T5HashTokenizer()('')[0, :2]) == [1, 0]   # </s>, pad


def test_default_tokenizer_is_gated_on_its_asset(monkeypatch, tmp_path):
    monkeypatch.setenv('STAR_TPU_T5_SPIECE', str(tmp_path / 'missing.model'))
    with pytest.raises(FileNotFoundError):
        default_t5_tokenizer()
    assert isinstance(default_t5_tokenizer(allow_fallback=True),
                      T5HashTokenizer)


def test_conditioner_matches_star_tpu(t5):
    """The CFG pair through the embedder registry: output keys, shapes and
    values equal the JAX conditioner's over the same T5 and tokenizer."""
    from star_tpu.models.conditioner import GeneralConditioner as JCond
    from star_tpu.models.conditioner import TextEmbedder as JEmb
    jm, params, ours = t5

    class Tok(T5HashTokenizer):
        def __call__(self, texts, max_length=10):
            return super().__call__(texts, max_length) % KW['vocab_size']

    cond = GeneralConditioner([TextEmbedder('txt', Tok(), ours)])
    jcond = JCond([JEmb('txt', Tok(), lambda tok: jm.apply(params, tok))])
    batch = {'txt': ['a boat', 'two cats']}
    (c, uc), (jc, juc) = (cond.get_unconditional_conditioning(batch),
                          jcond.get_unconditional_conditioning(batch))
    assert set(c) == set(uc) == set(jc) == {'crossattn'}
    assert c['crossattn'].shape == (2, 10, 64)
    assert_close(c['crossattn'], jc['crossattn'])
    assert_close(uc['crossattn'], juc['crossattn'])
    neg = cond.get_unconditional_conditioning(batch, {'txt': ['x', 'y']})[1]
    assert not torch.allclose(neg['crossattn'], uc['crossattn'])
    # training-time text dropout blanks every text at ucg_rate 1
    drop = GeneralConditioner([TextEmbedder('txt', Tok(), ours, 1.0)])
    torch.testing.assert_close(drop(batch)['crossattn'], uc['crossattn'])
