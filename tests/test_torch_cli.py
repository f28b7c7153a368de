"""The port's serving CLIs and their host-side I/O (star_tpu_torch/cli/,
data/, utils/logger.py, utils/seed.py, ops/resize.adjust_resolution),
each held on the same inputs against star_tpu's counterpart where one
exists: preprocess, adjust_resolution over a grid, load_video on an mp4
written through cv2 (frames and fps), save_video through the cv2 writer,
PrefetchIterator (order, an error re-raised at next(), close(), repeated
StopIteration), setup_seed's draws.

Then the CLIs end to end on the CPU (--device cpu) at tiny widths (the
model constructors and the latent grid monkeypatched small): inference_sr
reads an mp4 and writes the x4 clip, in single and batch mode, from random
weights and from files written by convert.cli, its frames equal to
enhance_a_video called directly, bit for bit; batch mode's count mismatch
and a missing model path raise before any model is built; sample_sr keeps
4k+1 frames and refuses fewer.
"""

import functools
import logging
import random
import sys
import time

import numpy as np
import pytest
import torch

import chip_smoke
from star_tpu_torch.cli import inference_sr, sample_sr
from star_tpu_torch.config import PipelineConfig, SamplerConfig
from star_tpu_torch.convert import cli as convert_cli
from star_tpu_torch.convert import load
from star_tpu_torch.convert.causal_vae_map import causal_vae_name_map
from star_tpu_torch.convert.tower_maps import (clip_text_name_map,
                                               dit_name_map, svd_vae_name_map,
                                               t5_encoder_name_map)
from star_tpu_torch.convert.unet_map import controlled_unet_name_map
from star_tpu_torch.data import io, prefetch
from star_tpu_torch.models.clip.text import CLIPTextEncoder
from star_tpu_torch.models.dit.dit import CogVideoDiT
from star_tpu_torch.models.t5.encoder import T5Encoder
from star_tpu_torch.models.unet.unet import ControlledV2VUNet
from star_tpu_torch.ops.resize import adjust_resolution
from star_tpu_torch.pipeline import CogModels, StarModels, build_pipeline
from star_tpu_torch.pipeline.build import _init_random
from star_tpu_torch.utils import logger as port_logger
from star_tpu_torch.utils.seed import setup_seed
from star_tpu_torch.vae.causal_vae import CogVideoVAE
from star_tpu_torch.vae.svd_vae import SVDTemporalVAE

@pytest.fixture(autouse=True, scope='module')
def one_thread():
    """One intra-op thread: these tensors are tiny, and torch's default of
    a thread per core slowed the tiny pipelines tenfold when the suite's
    workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_mp4(path, frames, fps=8.0):
    """frames [F, H, W, 3] uint8 RGB -> an mp4v file through cv2."""
    import cv2
    f, h, w, _ = frames.shape
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*'mp4v'), fps,
                             (w, h))
    for fr in frames:
        writer.write(np.ascontiguousarray(fr[:, :, ::-1]))
    writer.release()
    return str(path)


def clip_frames(seed, f, h, w):
    """Smooth frames, so that the mp4 round trip keeps them close."""
    r = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([np.sin(xx / 3.0 + c) + np.cos(yy / 4.0 - c)
                     for c in range(3)], -1)
    return np.stack([(base + 0.2 * i + 0.1 * r.standard_normal(3)) * 50 + 128
                     for i in range(f)]).clip(0, 255).astype(np.uint8)


# ------------------------------------------------------------ host-side I/O


def test_preprocess_matches_star_tpu():
    from star_tpu.data.io import preprocess as jpre
    frames = np.random.RandomState(0).randint(0, 256, (3, 5, 7, 3),
                                              dtype=np.uint8)
    out = io.preprocess(frames)
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, jpre(frames))


def test_adjust_resolution_matches_star_tpu_over_a_grid():
    from star_tpu.ops.resize import adjust_resolution as jadj
    for h in (90, 120, 179, 180, 240, 360, 480, 720, 1080):
        for w in (160, 213, 320, 426, 640, 1280, 1920):
            for up in (1, 2, 4):
                assert adjust_resolution(h, w, up) == jadj(h, w, up), \
                    (h, w, up)


def test_load_video_matches_star_tpu(tmp_path):
    from star_tpu.data.io import load_video as jload
    from star_tpu.data.io import load_video_with_timeout as jload_t
    path = write_mp4(tmp_path / 'a.mp4', clip_frames(1, 5, 24, 32), fps=12.0)
    frames, fps = io.load_video(path)
    want, want_fps = jload(path)
    assert frames.shape == (5, 24, 32, 3) and frames.dtype == np.uint8
    assert fps == want_fps == 12.0
    np.testing.assert_array_equal(frames, want)
    got_t, _ = io.load_video_with_timeout(path)
    np.testing.assert_array_equal(got_t, jload_t(path)[0])
    with pytest.raises(ValueError, match='no frames'):
        io.load_video(str(tmp_path / 'missing.mp4'))
    with pytest.raises(ValueError, match='no frames'):
        io.load_video_with_timeout(str(tmp_path / 'missing.mp4'))


def test_save_video_through_the_cv2_writer_matches_star_tpu(tmp_path,
                                                             monkeypatch):
    """No ffmpeg binary and no imageio: both fall back to cv2's mp4v
    writer, and both files decode to the same frames."""
    from star_tpu.data import io as jio
    monkeypatch.setattr(io.shutil, 'which', lambda name: None)
    monkeypatch.setattr(jio.shutil, 'which', lambda name: None)
    monkeypatch.setitem(sys.modules, 'imageio', None)
    frames = clip_frames(2, 4, 24, 32)
    ours = io.save_video(frames, str(tmp_path / 'port'), 'v.mp4', fps=10.0)
    theirs = jio.save_video(frames, str(tmp_path / 'jax'), 'v.mp4', fps=10.0)
    assert ours == str(tmp_path / 'port' / 'v.mp4')
    got, fps = io.load_video(ours)
    want, _ = io.load_video(theirs)
    assert got.shape == frames.shape and fps == 10.0
    np.testing.assert_array_equal(got, want)
    assert np.abs(got.astype(int) - frames.astype(int)).mean() < 8


def _drain(it):
    out = []
    try:
        for x in it:
            out.append(x)
    except RuntimeError as e:
        out.append(str(e))
    return out


def test_prefetch_iterator_matches_star_tpu():
    from star_tpu.data.prefetch import PrefetchIterator as JPrefetch

    def failing():
        yield from range(3)
        raise RuntimeError('decode failed')

    for make in (lambda: range(7), failing):
        ours, theirs = prefetch.PrefetchIterator(make(), depth=2), \
            JPrefetch(make(), depth=2)
        assert _drain(ours) == _drain(theirs)
        # the iterator protocol holds after the end
        for it in (ours, theirs):
            with pytest.raises(StopIteration):
                next(it)
            with pytest.raises(StopIteration):
                next(it)
    assert _drain(prefetch.PrefetchIterator(failing()))[-1] == \
        'decode failed'


def test_prefetch_close_stops_a_blocked_producer():
    produced = []

    def endless():
        i = 0
        while True:
            produced.append(i)
            yield i
            i += 1

    it = prefetch.PrefetchIterator(endless(), depth=1)
    assert next(it) == 0
    it.close()
    it._thread.join(timeout=10)
    assert not it._thread.is_alive()
    n = len(produced)
    time.sleep(0.2)
    assert len(produced) == n <= 4
    fresh = prefetch.prefetched(lambda: range(3))
    assert list(fresh()) == list(fresh()) == [0, 1, 2]


def test_setup_seed_draws_as_star_tpu_and_returns_a_generator():
    from star_tpu.utils.seed import setup_seed as jseed
    jseed(5)
    want = (random.random(), np.random.rand())
    g = setup_seed(5, device='cpu')
    assert (random.random(), np.random.rand()) == want
    assert isinstance(g, torch.Generator) and g.device.type == 'cpu'
    assert torch.equal(torch.randn(3, generator=g),
                       torch.randn(3, generator=torch.Generator()
                                   .manual_seed(5)))
    a = torch.rand(2)
    setup_seed(5, device='cpu')
    assert torch.equal(torch.rand(2), a)


def test_logger_is_quiet_off_rank_0(monkeypatch):
    assert port_logger.get_logger('port_rank0').level == logging.INFO
    monkeypatch.setattr(port_logger.dist, 'is_initialized', lambda: True)
    monkeypatch.setattr(port_logger.dist, 'get_rank', lambda: 3)
    assert port_logger.get_logger('port_rank3').level == logging.WARNING
    # one handler, however often it is asked for
    assert len(port_logger.get_logger('port_rank3').handlers) == 1


# ---------------------------------------------------- inference_sr (I2VGen)

UNET_MAP = dict(dim=32, dim_mult=(1, 2), num_res_blocks=1,
                attn_scales=(1.0, 0.5))
UNET_KW = dict(head_dim=16, num_heads_init_temporal=2, context_dim=32)
VAE_CHS = (32, 32, 32, 32)
# CLIP keeps its vocabulary: the tokenizers give ids up to 49407
CLIP_KW = dict(width=32, heads=2, layers=2)
STAR_TINY = {
    'unet': (lambda: ControlledV2VUNet(**UNET_MAP, **UNET_KW),
             lambda: controlled_unet_name_map(**UNET_MAP)),
    'vae': (lambda: SVDTemporalVAE(VAE_CHS, 1, 1),
            lambda: svd_vae_name_map(VAE_CHS, 1)),
    'clip': (lambda: CLIPTextEncoder(**CLIP_KW),
             lambda: clip_text_name_map(CLIP_KW['layers'])),
}
FRAMES = (4, 20, 16)         # x4 -> 80x64, the patched latent grid's size
CLI_FLAGS = ['--solver_mode', 'normal', '--steps', '2', '--max_chunk_len',
             '4', '--dtype', 'float32', '--device', 'cpu']
TINY_CFG = functools.partial(PipelineConfig, pad_grid=(80, 64))


def tiny_star_models(seed=0, dtype=torch.float32, device='cpu'):
    return StarModels(*_init_random(
        [STAR_TINY[k][0] for k in ('unet', 'vae', 'clip')], seed, dtype,
        device))


@pytest.fixture
def tiny_star(monkeypatch):
    """The CLI's models and latent grid cut to the tiny sizes above, and
    the saver recording each clip's frames."""
    monkeypatch.setattr(inference_sr, 'init_random_models', tiny_star_models)
    monkeypatch.setattr(inference_sr, 'PipelineConfig', TINY_CFG)
    monkeypatch.setattr(load, 'tower', lambda kind, num_layers=None,
                        liem=True: (STAR_TINY[kind][0], STAR_TINY[kind][1]()))
    written = {}
    real_save = inference_sr.save_video

    def save(frames, save_dir, name, fps=16.0):
        written[name] = frames
        return real_save(frames, save_dir, name, fps=fps)
    monkeypatch.setattr(inference_sr, 'save_video', save)
    return written


def test_inference_sr_main_writes_the_x4_clip_equal_to_a_direct_call(
        tiny_star, tmp_path):
    src = write_mp4(tmp_path / 'in.mp4', clip_frames(3, *FRAMES))
    out_dir = tmp_path / 'out'
    saved = inference_sr.main(['--input_path', src, '--save_dir',
                               str(out_dir), '--file_name', 'x4.mp4',
                               '--model_path', str(tmp_path / 'none'),
                               '--allow_random_weights'] + CLI_FLAGS)
    assert saved == [str(out_dir / 'x4.mp4')]
    back, fps = io.load_video(saved[0])
    assert back.shape == (4, 80, 64, 3) and back.dtype == np.uint8
    assert fps == 8.0
    cli_frames = tiny_star['x4.mp4']
    assert cli_frames.shape == (4, 80, 64, 3) and cli_frames.std() > 0

    frames, _ = io.load_video(src)
    pipe = build_pipeline(tiny_star_models(), TINY_CFG(
        sampler=SamplerConfig(steps=2, solver_mode='normal')),
        allow_hash_tokenizer=True, device='cpu')
    np.testing.assert_array_equal(
        cli_frames, pipe.enhance_a_video(frames, 'a good video', seed=666))


def test_inference_sr_serves_files_written_by_convert_cli(
        tiny_star, tmp_path, monkeypatch):
    """The tiny random models as reference-named checkpoints ->
    convert.cli -> --model_path: the same frames as from the models
    themselves. Served weights ask for the CLIP BPE table, which the
    repository lacks: the hash tokenizer stands in."""
    from star_tpu_torch.models.clip.tokenizer import default_tokenizer
    from star_tpu_torch.pipeline import build
    monkeypatch.setattr(build, 'default_tokenizer',
                        lambda allow_fallback: default_tokenizer(
                            allow_fallback=True))
    models = tiny_star_models()
    weights = tmp_path / 'weights'
    weights.mkdir()
    for kind, model in (('unet', models.unet), ('vae', models.vae),
                        ('clip', models.text)):
        ref = tmp_path / f'ref_{kind}.pt'
        torch.save(chip_smoke.to_reference(STAR_TINY[kind][1](),
                                           model.state_dict()), ref)
        convert_cli.main([kind, str(ref), str(weights / f'{kind}.pt')])
    src = write_mp4(tmp_path / 'in.mp4', clip_frames(4, *FRAMES))
    common = ['--input_path', src, '--save_dir', str(tmp_path / 'out')]
    inference_sr.main(common + ['--model_path', str(weights), '--file_name',
                                'files.mp4'] + CLI_FLAGS)
    inference_sr.main(common + ['--model_path', str(tmp_path / 'none'),
                                '--allow_random_weights', '--file_name',
                                'random.mp4'] + CLI_FLAGS)
    np.testing.assert_array_equal(tiny_star['files.mp4'],
                                  tiny_star['random.mp4'])


def test_inference_sr_batch_mode(tiny_star, tmp_path):
    vids = tmp_path / 'vids'
    vids.mkdir()
    for i, name in enumerate(('b.mp4', 'a.mp4')):
        write_mp4(vids / name, clip_frames(10 + i, *FRAMES))
    prompts = tmp_path / 'prompts.txt'
    prompts.write_text('a cat\n\na dog\n')
    saved = inference_sr.main(['--input_dir', str(vids), '--prompt_file',
                               str(prompts), '--save_dir',
                               str(tmp_path / 'out'), '--model_path',
                               str(tmp_path / 'none'),
                               '--allow_random_weights'] + CLI_FLAGS)
    assert saved == [str(tmp_path / 'out' / n) for n in ('a.mp4', 'b.mp4')]
    for path in saved:
        assert io.load_video(path)[0].shape == (4, 80, 64, 3)
    # sorted videos pair with the prompts in order
    pipe = build_pipeline(tiny_star_models(), TINY_CFG(
        sampler=SamplerConfig(steps=2, solver_mode='normal')),
        allow_hash_tokenizer=True, device='cpu')
    np.testing.assert_array_equal(tiny_star['b.mp4'], pipe.enhance_a_video(
        io.load_video(str(vids / 'b.mp4'))[0], 'a dog', seed=666))


def test_inference_sr_checks_its_jobs_before_building_models(
        tiny_star, tmp_path, monkeypatch):
    def never(*a, **k):
        raise AssertionError('a model was built')
    monkeypatch.setattr(inference_sr, 'init_random_models', never)
    monkeypatch.setattr(inference_sr, 'load_star_models', never)
    vids = tmp_path / 'vids'
    vids.mkdir()
    for name in ('a.mp4', 'b.mp4'):
        write_mp4(vids / name, clip_frames(0, *FRAMES))
    prompts = tmp_path / 'prompts.txt'
    prompts.write_text('only one\n')
    base = ['--model_path', str(tmp_path / 'none'), '--allow_random_weights',
            '--device', 'cpu']
    with pytest.raises(ValueError, match='2 videos but 1 prompts'):
        inference_sr.main(['--input_dir', str(vids), '--prompt_file',
                           str(prompts)] + base)
    with pytest.raises(FileNotFoundError, match='no \\*.mp4'):
        inference_sr.main(['--input_dir', str(tmp_path)] + base)
    with pytest.raises(FileNotFoundError, match='gone.mp4'):
        inference_sr.main(['--input_path', str(tmp_path / 'gone.mp4')]
                          + base)
    with pytest.raises(ValueError, match='--input_path or --input_dir'):
        inference_sr.main(base)
    with pytest.raises(FileNotFoundError, match='allow_random_weights'):
        inference_sr.main(['--input_path', str(vids / 'a.mp4'),
                           '--model_path', str(tmp_path / 'none'),
                           '--device', 'cpu'])


def test_inference_sr_refuses_float32_on_the_card(tmp_path, monkeypatch):
    """--dtype float32 on a CUDA device raises, naming the flag and the
    bf16 kernels, before any job is checked or model built (the input
    does not exist); on the CPU the flag is taken (the tests above)."""
    def never(*a, **k):
        raise AssertionError('a job or model was made')
    for name in ('make_jobs', 'init_random_models', 'load_star_models'):
        monkeypatch.setattr(inference_sr, name, never)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    with pytest.raises(ValueError, match='--dtype float32.*bf16'):
        inference_sr.main(['--input_path', str(tmp_path / 'gone.mp4'),
                           '--allow_random_weights', '--dtype', 'float32'])
    with pytest.raises(ValueError, match='--dtype float32'):
        inference_sr.main(['--input_path', str(tmp_path / 'gone.mp4'),
                           '--dtype', 'float32', '--device', 'cuda:0'])


# ------------------------------------------------------ sample_sr (CogVideo)

COG_TINY = {
    # the hash tokenizer gives 226 ids below T5's 32128
    'dit': (lambda: CogVideoDiT(hidden_size=64, num_layers=1, num_heads=1,
                                patch_size=2, latent_channels=4,
                                text_hidden_size=32, text_length=226,
                                time_embed_dim=16),
            lambda: dit_name_map(1, 1)),
    'causal_vae': (lambda: CogVideoVAE(ch=32, ch_mult=(1, 1, 1, 1),
                                       num_res_blocks=1, z_channels=4),
                   lambda: causal_vae_name_map(32, (1, 1, 1, 1), 1)),
    't5': (lambda: T5Encoder(d_model=32, d_ff=48, num_heads=2, num_layers=1),
           lambda: t5_encoder_name_map(1)),
}


def test_sample_sr_keeps_4k_plus_1_frames(monkeypatch, tmp_path):
    def tiny(seed=0, dtype=torch.bfloat16, device='cpu'):
        return CogModels(*_init_random(
            [COG_TINY[k][0] for k in ('dit', 'causal_vae', 't5')], seed,
            dtype, device))
    monkeypatch.setattr(sample_sr, 'init_random_cog_models', tiny)
    written = {}

    def save(frames, save_dir, name, fps=16.0):
        written[name] = frames
        return name
    monkeypatch.setattr(sample_sr, 'save_video', save)
    common = ['--prompt', 'a boat', '--sampling_num_frames', '3',
              '--num_steps', '2', '--model_path', str(tmp_path / 'none'),
              '--allow_random_weights', '--device', 'cpu']
    short = write_mp4(tmp_path / 'short.mp4', clip_frames(5, 8, 32, 48))
    with pytest.raises(ValueError, match='need 9 frames'):
        sample_sr.main(['--input_path', short] + common)
    src = write_mp4(tmp_path / 'long.mp4', clip_frames(6, 11, 32, 48))
    assert sample_sr.main(['--input_path', src] + common) == ['long.mp4']
    out = written['long.mp4']
    assert out.shape == (9, 32, 48, 3) and out.dtype == np.uint8
    with pytest.raises(FileNotFoundError):
        sample_sr.main(['--input_path', src, '--model_path',
                        str(tmp_path / 'none'), '--device', 'cpu'])
