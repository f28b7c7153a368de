"""The port's training CLIs (star_tpu_torch/cli/make_paired_data.py,
train_sr.py, train_cog.py) and their checkpoints (train/checkpoint.py) on
the CPU (--device cpu) at tiny widths (the model constructors
monkeypatched small, as tests/test_torch_cli.py does for serving):

  * make_paired_data's per-clip pair against the JAX CLI's per-clip
    computation with the JAX draws injected; then the CLI from a CSV of
    mp4s to {gt, lq, text} triplets, rank striding included;
  * train_sr and train_cog, two steps each from those triplets; their
    metrics.jsonl rows carry the JAX CLIs' keys (the JAX steps' metrics,
    read by jax.eval_shape, and step, lr, sec_per_step), which are also
    chip_smoke.py's constants;
  * a run resumed from its step-2 checkpoint equals the run continued to
    step 3, bit for bit (fp32); max_to_keep and the save interval follow
    orbax's default policy;
  * --data_parallel 2 on two gloo processes (torchrun's environment)
    equal to one process at the global batch: the metrics rows and the
    step-2 checkpoint; --coordinator taken by one process;
  * the refusals: a process count that is not data x tensor (naming
    torchrun), a DiT file with its LoRA merged, --device cuda without a
    card;
  * collect_samples and stack_batch on the setup of
    tests/test_train_cli.py:139-154, against star_tpu's.
"""

import csv
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from star_tpu_torch.cli import make_paired_data, train_cog, train_sr
from star_tpu_torch.convert.convert import save_params
from star_tpu_torch.train.checkpoint import CheckpointManager
from test_torch_cli import clip_frames, tiny_star_models, write_mp4
from test_torch_degradation import _draw
from torch_parallel_worker import cog_towers

HW = (80, 64)               # the tiny UNet's latent grid 10x8
PAIR = ['--num_frames', '5', '--frame_interval', '1', '--height',
        str(HW[0]), '--width', str(HW[1]), '--device', 'cpu']


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------- make_paired_data


def test_make_pair_matches_the_jax_cli_per_clip(tmp_path):
    """One clip of 7 frames of 90x70 (interval 1, 5 frames, cropped and
    resized to 80x64 through cv2 on both sides), clip index 1 (seed
    3 + 7919): gt bit for bit; the LQ before the upsample within the
    degradation's tolerance (tests/test_torch_degradation.py); the x4
    cubic upsample in uint8 within one level where a value sits on a
    rounding edge."""
    from star_tpu.cli.make_paired_data import center_crop_resize
    from star_tpu.data.degradation import degrade_video as jdegrade
    frames = clip_frames(1, 7, 90, 70)
    seed = 3 + 1 * 7919
    kw = dict(num_frames=5, frame_interval=1, height=HW[0], width=HW[1],
              scale=4, seed=3, use_codec=True, recipe='mid', device='cpu')
    gt, lq, lq01 = make_paired_data.make_pair(frames, index=1,
                                              draw=_draw(seed), **kw)
    # the JAX CLI's loop body (star_tpu/cli/make_paired_data.py:80-93)
    f = center_crop_resize(frames[::1][:5], *HW)
    gt01 = f.astype(np.float32) / 255.0
    jlq01, _ = jdegrade(gt01, scale=4, seed=seed, use_codec=True,
                        recipe='mid')
    jup = np.clip(np.asarray(jax.image.resize(
        jnp.asarray(jlq01), (5, *HW, 3), 'cubic')), 0, 1)
    assert gt.dtype == lq.dtype == torch.uint8
    assert np.array_equal(gt.numpy(), (gt01 * 255).astype(np.uint8))
    assert lq01.shape == (5, 20, 16, 3)
    assert float((lq01 - torch.from_numpy(jlq01)).abs().max()) <= 3 / 255
    d = np.abs(lq.numpy().astype(int) - (jup * 255).astype(np.uint8))
    assert lq.shape == (5, *HW, 3) and d.max() <= 1 and d.mean() < 0.01


def write_triplets(tmp_path, n=2, process=(0, 1)):
    """A CSV of n mp4s of 6 frames of 96x72, through make_paired_data."""
    rows = []
    for i in range(n):
        path = write_mp4(tmp_path / f'src{i}.mp4', clip_frames(10 + i, 6, 96,
                                                               72))
        rows.append([path, f'clip number {i}'])
    with open(tmp_path / 'data.csv', 'w', newline='') as f:
        csv.writer(f).writerows(rows)
    out = tmp_path / 'paired'
    names = make_paired_data.main(
        ['--csv', str(tmp_path / 'data.csv'), '--save_dir', str(out),
         '--seed', '5', '--process_index', str(process[0]),
         '--process_count', str(process[1])] + PAIR)
    return str(out), names


def test_make_paired_data_cli_writes_triplets_with_rank_striding(tmp_path):
    from star_tpu_torch.data.io import load_video
    root, names = write_triplets(tmp_path, n=3, process=(1, 2))
    assert names == ['src1']                         # rows 1::2
    gt, _ = load_video(os.path.join(root, 'gt', 'src1.mp4'))
    lq, _ = load_video(os.path.join(root, 'lq', 'src1.mp4'))
    assert gt.shape == lq.shape == (5, *HW, 3)
    assert float(np.abs(gt.astype(float) - lq).mean()) > 1.0
    assert open(os.path.join(root, 'text', 'src1.txt')).read() == \
        'clip number 1'


# -------------------------------------------------------------- train_sr


def jax_row_keys(kind):
    """The metric keys of star_tpu's train step, traced (not compiled)
    with jax.eval_shape at tiny widths, plus the JAX CLIs' step, lr and
    sec_per_step."""
    from star_tpu.models.dit.dit import CogVideoDiT as JDiT
    from star_tpu.train import TrainState
    key = jax.random.PRNGKey(0)
    if kind == 'sr':
        from star_tpu.diffusion import DiffusionTables, default_star_schedule
        from star_tpu.models.unet.unet import ControlledV2VUNet
        from star_tpu.train import TrainConfig, make_train_state, \
            make_train_step
        m = ControlledV2VUNet(dim=32, dim_mult=(1,), num_res_blocks=1,
                              attn_scales=(), head_dim=16,
                              num_heads_init_temporal=2, context_dim=32)
        x = jnp.zeros((1, 2, 10, 8, 4))
        params = jax.eval_shape(m.init, key, x, jnp.zeros((1,), jnp.int32),
                                jnp.zeros((1, 7, 32)), x)
        cfg = TrainConfig()
        _, tx = make_train_state(cfg, params)
        step = make_train_step(
            cfg, lambda p, xx, tt, yy, hh: m.apply(p, xx, tt, yy, hh),
            DiffusionTables.from_schedule(default_star_schedule()), tx,
            vae_decode=lambda z: jnp.zeros(z.shape[:2] + (80, 64, 3)))
        batch = {'gt_latent': x, 'lq_latent': x, 'y': jnp.zeros((1, 7, 32)),
                 'gt_pixels': jnp.zeros((1, 2, 80, 64, 3))}
    else:
        from star_tpu.train.cog_trainer import (CogTrainConfig,
                                                make_cog_train_step)
        freq = kind == 'cog_freq'
        m = JDiT(hidden_size=32, num_layers=1, num_heads=1, patch_size=2,
                 latent_channels=4, text_hidden_size=8, text_length=4,
                 time_embed_dim=8, lora_rank=2)
        x = jnp.zeros((1, 2, 4, 4, 4))
        params = jax.eval_shape(m.init, key, jnp.zeros((1, 2, 4, 4, 8)),
                                jnp.zeros((1,), jnp.int32),
                                jnp.zeros((1, 4, 8)))
        cfg = CogTrainConfig(freq_loss=freq)
        import optax
        tx = optax.adamw(1e-4)
        step = make_cog_train_step(
            cfg, lambda p, xx, i, y: m.apply(p, xx, i, y), tx,
            vae_decode=lambda z: jnp.zeros((1, 5, 32, 32, 3)))
        batch = {'gt_latent': x, 'lq_latent': x, 'y': jnp.zeros((1, 4, 8))}
        if freq:
            batch['gt_pixels'] = jnp.zeros((1, 5, 32, 32, 3))
    state = TrainState(jnp.zeros((), jnp.int32), params,
                       jax.eval_shape(tx.init, params), None)
    _, metrics = jax.eval_shape(step, state, batch, key)
    return set(metrics) | {'step', 'lr', 'sec_per_step'}


def rows(out_dir):
    with open(os.path.join(out_dir, 'metrics.jsonl')) as f:
        return [json.loads(line) for line in f]


@pytest.fixture
def tiny_sr(monkeypatch):
    monkeypatch.setattr(train_sr, 'init_random_models', tiny_star_models)


def sr_main(root, out, *extra):
    return train_sr.main(['--data_root', root, '--output_dir', str(out),
                          '--allow_random_weights', '--num_frames', '4',
                          '--learning_rate', '1e-3', '--device', 'cpu',
                          *extra])


def test_train_sr_trains_from_the_triplets_and_resumes_exactly(tiny_sr,
                                                               tmp_path):
    """Two steps and the rows; then a run of 3 steps against one of 2
    steps resumed to 3 from its step-2 checkpoint: the same masters, AdamW
    moments, EMA and step-3 row, bit for bit."""
    root, _ = write_triplets(tmp_path)
    state = sr_main(root, tmp_path / 'a', '--max_train_steps', '3',
                    '--checkpointing_steps', '2', '--ema_decay', '0.9',
                    '--sample_every', '3')
    got = rows(tmp_path / 'a')
    assert [r['step'] for r in got] == [1, 2, 3]
    assert set(got[0]) == chip_smoke.TRAIN_SR_ROW_KEYS == jax_row_keys('sr')
    assert all(np.isfinite(v) for r in got for v in r.values())
    assert os.path.exists(tmp_path / 'a' / 'samples' / 'step000003.mp4')
    assert CheckpointManager(str(tmp_path / 'a' / 'ckpt')).all_steps() == \
        [1, 2]
    sr_main(root, tmp_path / 'b', '--max_train_steps', '2',
            '--checkpointing_steps', '2', '--ema_decay', '0.9',
            '--sample_every', '3')
    resumed = sr_main(root, tmp_path / 'b', '--max_train_steps', '3',
                      '--checkpointing_steps', '2', '--ema_decay', '0.9',
                      '--sample_every', '3', '--resume')
    assert resumed.step == state.step == 3
    for n in state.params:
        assert torch.equal(resumed.params[n], state.params[n]), n
        assert torch.equal(resumed.ema_params[n], state.ema_params[n]), n
    for a, b in zip(resumed.opt_state.adamw.state.values(),
                    state.opt_state.adamw.state.values()):
        assert all(torch.equal(a[k], b[k]) for k in a)
    last = rows(tmp_path / 'b')[-1]
    assert last['step'] == 3
    assert {k: v for k, v in last.items() if k != 'sec_per_step'} == \
        {k: v for k, v in got[-1].items() if k != 'sec_per_step'}


def test_train_sr_refuses_parallel_flags_and_a_missing_card(tmp_path,
                                                            monkeypatch):
    """--data_parallel / --tensor_parallel above 1 in one process raise,
    naming torchrun, before any model is built."""
    monkeypatch.setattr(train_sr, 'init_random_models', None)   # not reached
    for flags in (['--data_parallel', '2'], ['--tensor_parallel', '2']):
        with pytest.raises(ValueError, match='torchrun --nproc_per_node 2'):
            sr_main(str(tmp_path), tmp_path / 'o', *flags)
    with pytest.raises(RuntimeError, match='CUDA'):
        train_sr.main(['--data_root', str(tmp_path), '--output_dir',
                       str(tmp_path / 'o'), '--allow_random_weights'])
    with pytest.raises(FileNotFoundError):
        train_sr.main(['--data_root', str(tmp_path), '--output_dir',
                       str(tmp_path / 'o'), '--device', 'cpu'])


# ------------------------------------------------------------- train_cog


def cog_triplets(tmp_path):
    """make_pair's clips of 9 frames (3 latent frames: the causal VAE
    decodes an odd count back to 4k+1) with the LQ at a quarter of the
    size, as CogPairedCaptionDataset expects below 720 wide (it upsamples
    x4)."""
    from star_tpu_torch.data.io import save_video
    root = tmp_path / 'cog'
    for i in range(2):
        gt, _, lq01 = make_paired_data.make_pair(
            clip_frames(20 + i, 9, 32, 48), index=i, num_frames=9,
            frame_interval=1, height=32, width=48, device='cpu')
        save_video(gt.numpy(), str(root / 'gt'), f'c{i}.mp4', fps=8)
        save_video((lq01 * 255).to(torch.uint8).numpy(), str(root / 'lq'),
                   f'c{i}.mp4', fps=8)
        os.makedirs(root / 'text', exist_ok=True)
        (root / 'text' / f'c{i}.txt').write_text(f'a <i>clip</i> {i}')
    return str(root)


def cog_main(root, out, *extra):
    return train_cog.main(['--data_root', root, '--output_dir', str(out),
                           '--num_frames', '9', '--lora_rank', '4',
                           '--device', 'cpu', *extra])


@pytest.mark.parametrize('freq', [False, True])
def test_train_cog_trains_from_the_triplets(monkeypatch, tmp_path, freq):
    """Two steps of the tiny LoRA DiT (caption cleaning on), with and
    without the frequency loss: rows with the JAX CLI's keys, finite, a
    checkpoint; masters moved."""
    monkeypatch.setattr(train_cog, 'towers', cog_towers)
    root = cog_triplets(tmp_path)
    state = cog_main(root, tmp_path / 'o', '--allow_random_weights',
                     '--max_train_steps', '2', '--clean_captions',
                     *(['--freq_loss'] if freq else []))
    got = rows(tmp_path / 'o')
    want = chip_smoke.TRAIN_COG_FREQ_ROW_KEYS if freq else \
        chip_smoke.TRAIN_COG_ROW_KEYS
    assert want == jax_row_keys('cog_freq' if freq else 'cog')
    assert [r['step'] for r in got] == [1, 2] and set(got[0]) == want
    assert all(np.isfinite(v) for r in got for v in r.values())
    assert state.step == 2 and any('lora_b' in n for n in state.params)
    assert CheckpointManager(str(tmp_path / 'o' / 'ckpt')).latest_step() == 1


def test_train_cog_loads_lora_files_and_refuses_merged_ones(monkeypatch,
                                                            tmp_path):
    """--model_path with a dit.pt that keeps its LoRA keys trains; one
    without them (merged at conversion) is refused, its missing keys
    named, before any step."""
    monkeypatch.setattr(train_cog, 'towers', cog_towers)
    root = cog_triplets(tmp_path)
    weights = tmp_path / 'w'
    os.makedirs(weights)
    towers = cog_towers(4)
    for kind in ('causal_vae', 't5'):
        save_params(str(weights / f'{kind}.pt'), towers[kind]().state_dict())
    save_params(str(weights / 'dit.pt'), towers['dit']().state_dict())
    # --allow_random_weights for the hash tokenizer only: the weights are
    # read from --model_path, which exists
    state = cog_main(root, tmp_path / 'o', '--model_path', str(weights),
                     '--max_train_steps', '1', '--allow_random_weights')
    assert state.step == 1
    save_params(str(weights / 'dit.pt'), cog_towers(0)['dit']().state_dict())
    with pytest.raises(ValueError, match=r'lora_a.*--merge-lora'):
        cog_main(root, tmp_path / 'o2', '--model_path', str(weights),
                 '--allow_random_weights')
    for flags, n in ((['--data_parallel', '2'], 2),
                     (['--tensor_parallel', '4'], 4)):
        with pytest.raises(ValueError, match=f'torchrun --nproc_per_node {n}'):
            cog_main(root, tmp_path / 'o3', *flags)


# ------------------------------------------------------ several processes


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        return sock.getsockname()[1]


def _cli_process(kind, argv, rank=None, world=None, port=None):
    """tests/torch_parallel_worker.py's CLI mode in a process of its own,
    one torch thread, in torchrun's environment when given a rank. The
    T5 hash tokenizer hashes words with Python's hash(), which each
    process salts anew unless PYTHONHASHSEED is set: set, so that every
    process gets the same ids."""
    import subprocess
    import sys
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, OMP_NUM_THREADS='1', PYTHONHASHSEED='0',
               PYTHONPATH=os.pathsep.join(
        [os.path.join(here, '..'), here, os.environ.get('PYTHONPATH', '')]))
    if rank is not None:
        env.update(RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
                   MASTER_ADDR='127.0.0.1', MASTER_PORT=str(port))
    return subprocess.Popen(
        [sys.executable, os.path.join(here, 'torch_parallel_worker.py'),
         'cli', kind, *argv], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)


@pytest.mark.parametrize('kind', ['sr', 'cog'])
def test_train_cli_data_parallel_equals_one_process(tmp_path, kind):
    """--data_parallel 2 --batch_size 1 on two gloo processes against one
    process with --batch_size 2, two steps: the same metrics rows (rank 0
    alone writes them) and the same step-2 checkpoint (masters, AdamW
    moments gathered from the ZeRO parts, EMA, generator state). The two
    runs differ in the order of their batch sums (one GEMM over two rows
    against two GEMMs and an all-reduce), so the checkpoint's tensors are
    held within 1e-5 and the metrics within 1e-5 of their size."""
    if kind == 'sr':
        root, _ = write_triplets(tmp_path)
        flags = ['--data_root', root, '--allow_random_weights',
                 '--num_frames', '4', '--learning_rate', '1e-3',
                 '--ema_decay', '0.9']
    else:
        root = cog_triplets(tmp_path)
        flags = ['--data_root', root, '--allow_random_weights',
                 '--num_frames', '9', '--lora_rank', '4', '--freq_loss',
                 '--ema_decay', '0.9']
    flags += ['--device', 'cpu', '--max_train_steps', '2',
              '--checkpointing_steps', '2']
    port = _free_port()
    dp, one = tmp_path / 'dp', tmp_path / 'one'
    procs = [_cli_process(kind, flags + ['--output_dir', str(dp),
                                         '--data_parallel', '2',
                                         '--batch_size', '1'], r, 2, port)
             for r in range(2)]
    procs.append(_cli_process(kind, flags + ['--output_dir', str(one),
                                             '--batch_size', '2']))
    logs = [p.communicate(timeout=600)[0].decode() for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0], \
        '\n'.join(logs)[-3000:]
    got, want = rows(dp), rows(one)
    assert [r['step'] for r in got] == [r['step'] for r in want] == [1, 2]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in set(g) - {'sec_per_step'}:
            assert g[k] == pytest.approx(w[k], rel=1e-5, abs=1e-7), k
    a, b = (torch.load(os.path.join(d, 'ckpt', 'step_00000002.pt'),
                       weights_only=True) for d in (dp, one))
    assert a['step'] == b['step'] == 2
    assert torch.equal(a['generator'], b['generator'])
    for part in ('params', 'ema'):
        assert set(a[part]) == set(b[part])
        for n, v in b[part].items():
            assert torch.allclose(a[part][n], v, rtol=0, atol=1e-5), n
    assert a['opt']['param_groups'] == b['opt']['param_groups']
    for i, st in b['opt']['state'].items():
        for k, v in st.items():
            assert torch.allclose(a['opt']['state'][i][k], v, rtol=0,
                                  atol=1e-5), (i, k)


def test_train_sr_takes_a_coordinator(tiny_sr, tmp_path):
    """--coordinator host:port starts a one-process gloo world (the
    rendezvous of processes that torchrun did not start), trains and
    ends the world it started."""
    import torch.distributed as dist
    root, _ = write_triplets(tmp_path)
    state = sr_main(root, tmp_path / 'c', '--max_train_steps', '1',
                    '--coordinator', f'127.0.0.1:{_free_port()}')
    assert state.step == 1 and [r['step'] for r in rows(tmp_path / 'c')] \
        == [1]
    assert not dist.is_initialized()


# ------------------------------------------------- checkpoints and batches


def test_checkpoint_manager_follows_orbax_policy(tmp_path):
    """Saved when no checkpoint exists or at a multiple of the interval,
    never at or below the latest; the newest max_to_keep kept; a restore
    gives back masters, moments, step, EMA and the generator's state."""
    from star_tpu_torch.train import TrainConfig, make_train_state
    model = torch.nn.Module()
    model.controlnet = torch.nn.Linear(3, 2)
    model.frozen = torch.nn.Linear(2, 2)
    state, tx = make_train_state(TrainConfig(ema_decay=0.5), model)
    g = torch.Generator().manual_seed(1)
    ck = CheckpointManager(str(tmp_path / 'ck'), max_to_keep=3,
                           save_interval_steps=3)
    saved = []
    for step in range(1, 11):
        state.params['controlnet.weight'].add_(1.0)
        tx.update({n: torch.ones_like(p) for n, p in state.params.items()},
                  step)
        state = state._replace(step=step)
        if ck.save(step, state, g):
            saved.append(step)
        torch.randn(2, generator=g)
    assert saved == [1, 3, 6, 9] and ck.all_steps() == [3, 6, 9]
    assert not ck.should_save(9) and not ck.should_save(8)
    want_w = state.params['controlnet.weight'].clone()
    moments = {k: v.clone() for k, v in
               tx.adamw.state[tx.adamw.param_groups[0]['params'][0]].items()}
    g_state = g.get_state()
    ck.save(12, state, g)
    torch.randn(5, generator=g)
    state.params['controlnet.weight'].zero_()
    back = ck.restore(12, state, model, g)
    assert back.step == 10 and torch.equal(back.params['controlnet.weight'],
                                           want_w)
    assert torch.equal(model.controlnet.weight, want_w)
    got = tx.adamw.state[tx.adamw.param_groups[0]['params'][0]]
    assert all(torch.equal(got[k], v) for k, v in moments.items())
    assert torch.equal(g.get_state(), g_state)
    assert set(back.ema_params) == set(state.params)


def test_collect_samples_and_stack_batch_match_star_tpu():
    from star_tpu.cli.train_sr import collect_samples as jcollect
    from star_tpu.cli.train_sr import stack_batch as jstack
    data = [{'gt': np.full((2, 4, 4, 3), i, np.float32),
             'lq': np.zeros((2, 4, 4, 3), np.float32),
             'text': f't{i}'} for i in range(3)]
    samples, _ = train_sr.collect_samples(iter(data), lambda: iter(data), 5)
    jsamples, _ = jcollect(iter(data), lambda: iter(data), 5)
    assert [s['text'] for s in samples] == [s['text'] for s in jsamples] \
        == ['t0', 't1', 't2', 't0', 't1']
    gt, lq, texts = train_sr.stack_batch(samples)
    jgt, jlq, jtexts = jstack(jsamples)
    assert np.array_equal(gt, jgt) and np.array_equal(lq, jlq)
    assert texts == jtexts and gt.shape == (5, 2, 4, 4, 3)
    assert gt[2, 0, 0, 0, 0] == 2.0
