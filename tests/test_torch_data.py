"""The port's data modules and metrics (star_tpu_torch/data/dataset.py,
captions.py, webds.py, utils/metrics.py) against star_tpu's, on the setups
of tests/test_dataset.py and tests/test_aux.py (:13-24, :55-156).

The datasets and the shard reader are host-side in both packages: the same
samples, in the same order, with the same caption draws
(random.Random(seed)), equal bit for bit. The metrics within 1e-5 of the
JAX value (fp32, another summation order).
"""

import os
import tarfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from star_tpu_torch.data import captions, dataset, webds
from star_tpu_torch.data.io import save_video
from star_tpu_torch.utils import metrics


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def triplet_root(tmp_path_factory):
    root = tmp_path_factory.mktemp('paired')
    rng = np.random.RandomState(0)
    for sub in ('gt', 'lq', 'text'):
        os.makedirs(root / sub, exist_ok=True)
    for name in ('a', 'b', 'c'):
        frames = rng.randint(0, 255, (6, 32, 48, 3), dtype=np.uint8)
        save_video(frames, str(root / 'gt'), name + '.mp4', fps=8)
        save_video(frames // 2, str(root / 'lq'), name + '.mp4', fps=8)
        (root / 'text' / (name + '.txt')).write_text(
            f'A <b>clip</b> {name} http://x.com/v.mp4 &amp; more')
    return str(root)


def same_samples(ours, theirs):
    ours, theirs = list(ours), list(theirs)
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        assert set(a) == set(b)
        for k in a:
            if isinstance(a[k], np.ndarray):
                assert a[k].dtype == b[k].dtype
                assert np.array_equal(a[k], b[k]), k
            else:
                assert a[k] == b[k], k


@pytest.mark.parametrize('clean', [False, True])
def test_video_datasets_match(triplet_root, clean):
    """Two epochs of PairedCaptionVideoDataset and CogPairedCaptionDataset
    (shuffle and caption dropout from random.Random(seed), the x4 bicubic
    LQ rule below 720 wide), with and without caption cleaning."""
    from star_tpu.data import dataset as jdataset
    for ours, theirs, kw in (
            (dataset.PairedCaptionVideoDataset,
             jdataset.PairedCaptionVideoDataset, dict(num_frames=4)),
            (dataset.CogPairedCaptionDataset,
             jdataset.CogPairedCaptionDataset, dict(num_frames=5))):
        a = ours(triplet_root, seed=3, clean_captions=clean, **kw)
        b = theirs(triplet_root, seed=3, clean_captions=clean, **kw)
        for _ in range(2):
            same_samples(a, b)
    item = dataset.CogPairedCaptionDataset(triplet_root, num_frames=5,
                                           null_text_ratio=0.0)[0]
    assert item['gt'].shape == (5, 32, 48, 3)
    assert item['lq'].shape == (5, 128, 192, 3)


def test_paired_dataset_setup(triplet_root):
    ds = dataset.PairedCaptionVideoDataset(triplet_root, num_frames=4,
                                           null_text_ratio=0.0)
    assert len(ds) == 3
    item = ds[0]
    assert item['gt'].shape == item['lq'].shape == (4, 32, 48, 3)
    assert -1.0 <= item['gt'].min() and item['gt'].max() <= 1.0
    assert item['text'].startswith('A <b>clip</b> a')
    ds = dataset.PairedCaptionVideoDataset(triplet_root, num_frames=2,
                                           null_text_ratio=1.0)
    assert ds[0]['text'] == ''


def test_cog_fit_rules_match():
    """_fit: wider than 720 -> 2/3 resize and a centre crop to 480x720; LQ
    narrower than 720 -> x4 bicubic; 720 wide -> untouched."""
    from star_tpu.data.dataset import CogPairedCaptionDataset as J
    r = np.random.RandomState(1)
    for shape, is_lq in (((2, 720, 1280, 3), False), ((2, 30, 40, 3), True),
                         ((2, 30, 40, 3), False), ((2, 480, 720, 3), True)):
        x = r.randint(0, 255, shape, dtype=np.uint8)
        got = dataset.CogPairedCaptionDataset._fit(x, is_lq)
        want = J._fit(x, is_lq)
        assert got.shape == want.shape and np.array_equal(got, want)
    assert got.shape == (2, 480, 720, 3)


def test_image_dataset_matches(tmp_path):
    import cv2
    from star_tpu.data.dataset import PairedCaptionImageDataset as J
    rng = np.random.RandomState(0)
    for sub in ('gt', 'sr_bicubic'):
        os.makedirs(tmp_path / sub, exist_ok=True)
    for name, hw in (('a', (40, 60)), ('b', (16, 20))):
        for sub in ('gt', 'sr_bicubic'):
            cv2.imwrite(str(tmp_path / sub / f'{name}.png'),
                        rng.randint(0, 255, (*hw, 3), dtype=np.uint8))
    ds = dataset.PairedCaptionImageDataset(str(tmp_path), crop_size=(32, 48))
    same_samples(ds, J(str(tmp_path), crop_size=(32, 48)))
    assert ds[0]['gt'].shape == (1, 32, 48, 3)
    assert (ds[1]['gt'][0, 0] == -1.0).all()


def _cycle(ds):
    while True:
        yield from ds


@pytest.mark.parametrize('n', [1, 3, 5])
@pytest.mark.parametrize('kind', ['video', 'cog', 'image'])
def test_skip_equals_reading_past(triplet_root, tmp_path, monkeypatch, kind,
                                  n):
    """skip(n) leaves a dataset where reading n samples (across epochs)
    leaves it, the shuffles and caption draws included, without loading a
    file: the next four samples are equal bit for bit."""
    import cv2
    if kind == 'image':
        for sub in ('gt', 'sr_bicubic'):
            os.makedirs(tmp_path / sub)
            for i, name in enumerate('ab'):
                cv2.imwrite(str(tmp_path / sub / f'{name}.png'),
                            np.full((8, 12, 3), 40 * i, np.uint8))
        make = lambda: dataset.PairedCaptionImageDataset(
            str(tmp_path), crop_size=(8, 12))
    else:
        cls = {'video': dataset.PairedCaptionVideoDataset,
               'cog': dataset.CogPairedCaptionDataset}[kind]
        make = lambda: cls(triplet_root, num_frames=3, seed=5)
    read, skipped = make(), make()
    it = _cycle(read)
    for _ in range(n):
        next(it)

    def no_load(*a, **k):
        raise AssertionError('skip read a file')
    with monkeypatch.context() as m:
        m.setattr(dataset, 'load_video', no_load)
        m.setattr(cv2, 'imread', no_load)
        skipped.skip(n)
    it2 = _cycle(skipped)
    same_samples([next(it) for _ in range(4)], [next(it2) for _ in range(4)])


def test_shard_for_process_matches():
    from star_tpu.data.dataset import shard_for_process as j
    items = list(range(10))
    for n in (1, 3, 4):
        parts = [dataset.shard_for_process(items, i, n) for i in range(n)]
        assert parts == [j(items, i, n) for i in range(n)]
        assert sorted(sum(parts, [])) == items


CAPTIONS = [
    'A <b>Dog</b> running http://www.example.com/x.jpg #123 on the beach!!',
    '"Free shipping" — click on this 1920x1080 image jc6640vc page 3',
    '@someone   said: “hello”…  ‘world’  \\n next 192.168.0.1',
    '中文 mixed text with ——dashes—— and a__b__c__d underscores',
    'plain caption', '  Trailing Space  ', '&quot;quoted&quot; &amp; more']


def test_text_preprocessing_matches():
    from star_tpu.data.captions import text_preprocessing as j
    for cap in CAPTIONS:
        for use in (True, False):
            assert captions.text_preprocessing(cap, use) == j(cap, use), cap


def _make_shards(tmp_path, n_shards=3, per_shard=4):
    shards = []
    for s in range(n_shards):
        shard = tmp_path / f'shard-{s:03d}.tar'
        with tarfile.open(shard, 'w') as tf:
            for i in range(per_shard):
                key = f's{s}_{i}'
                p = tmp_path / (key + '.txt')
                p.write_text(f'caption {key}')
                tf.add(p, arcname=key + '.txt')
                p = tmp_path / (key + '.json')
                p.write_text(f'{{"i": {i}}}')
                tf.add(p, arcname=key + '.json')
        shards.append(str(shard))
    return shards


def _keys(ds):
    return [(s['__key__'], s['txt'], s['json']['i']) for s in ds]


def test_tar_video_dataset_matches(tmp_path):
    """A shard of {key.mp4, key.txt}: decoded samples equal; rank striding
    (tests/test_aux.py:55-76)."""
    from star_tpu.data.webds import TarVideoDataset as J
    vids = tmp_path / 'v'
    os.makedirs(vids)
    rng = np.random.RandomState(0)
    for key in ('s1', 's2'):
        save_video(rng.randint(0, 255, (4, 16, 16, 3), dtype=np.uint8),
                   str(vids), key + '.mp4', fps=4)
        (vids / (key + '.txt')).write_text('caption ' + key)
    shard = tmp_path / 'shard-000.tar'
    with tarfile.open(shard, 'w') as tf:
        for key in ('s1', 's2'):
            tf.add(vids / (key + '.mp4'), arcname=key + '.mp4')
            tf.add(vids / (key + '.txt'), arcname=key + '.txt')
    ours = list(webds.TarVideoDataset([str(shard)]))
    same_samples(ours, J([str(shard)]))
    assert ours[0]['txt'] == 'caption s1'
    assert ours[0]['mp4'].shape == (4, 16, 16, 3)
    assert len(list(webds.TarVideoDataset([str(shard)], 1, 2))) == 0


@pytest.mark.parametrize('rank', [0, 1])
def test_webds_shuffle_and_striding_match(tmp_path, rank):
    """Shard-order shuffle per epoch, the streaming shuffle buffer and rank
    striding over 2 processes: the same keys in the same order, two
    epochs (tests/test_aux.py:129-145)."""
    from star_tpu.data.webds import TarVideoDataset as J
    shards = _make_shards(tmp_path)
    kw = dict(process_index=rank, process_count=2, shuffle_seed=1,
              shuffle_buffer=3)
    ours, theirs = webds.TarVideoDataset(shards, **kw), J(shards, **kw)
    for _ in range(2):
        assert _keys(ours) == _keys(theirs)
    plain = _keys(webds.TarVideoDataset(shards))
    ep = _keys(webds.TarVideoDataset(shards, shuffle_seed=1,
                                     shuffle_buffer=6))
    assert sorted(ep) == sorted(plain) and ep != plain


def test_webds_resume_matches(tmp_path):
    """Resumable iteration (tests/test_aux.py:148-160): the state after five
    samples, loaded into a new reader, continues with the same samples
    in both packages."""
    from star_tpu.data.webds import TarVideoDataset as J
    shards = _make_shards(tmp_path)
    out = []
    for cls in (webds.TarVideoDataset, J):
        ds = cls(shards, shuffle_seed=3)
        it = iter(ds)
        head = [next(it)['__key__'] for _ in range(5)]
        state = ds.state_dict()
        rest = [s['__key__'] for s in it]
        ds2 = cls(shards, shuffle_seed=3)
        ds2.load_state_dict(state)
        resumed = [s['__key__'] for s in iter(ds2)]
        assert resumed[:len(rest)] == rest
        assert set(head).isdisjoint(rest)
        out.append((head, state, rest, resumed))
    assert out[0] == out[1]


def test_psnr_and_ssim_match():
    """psnr and ssim against the JAX metrics on random frames (within 1e-5
    relative), and the setups of tests/test_aux.py:13-30."""
    from star_tpu.utils import metrics as jm
    r = np.random.RandomState(0)
    a = r.uniform(0, 255, (3, 40, 36, 3)).astype(np.float32)
    b = np.clip(a + r.normal(0, 12, a.shape), 0, 255).astype(np.float32)
    for fn in ('psnr', 'ssim'):
        got = float(getattr(metrics, fn)(torch.from_numpy(a),
                                         torch.from_numpy(b)))
        want = float(getattr(jm, fn)(jnp.asarray(a), jnp.asarray(b)))
        assert got == pytest.approx(want, rel=1e-5), fn
    x = torch.from_numpy(r.uniform(0, 255, (2, 16, 16, 3)))
    assert float(metrics.psnr(x, x)) > 80
    assert float(metrics.psnr(x, x + 5.0)) > float(metrics.psnr(x, x + 20.0))
    assert float(metrics.psnr(x, x + 10.0)) == pytest.approx(28.13, abs=0.05)
    y = torch.from_numpy(r.uniform(0, 255, (2, 32, 32, 3)))
    assert float(metrics.ssim(y, y)) == pytest.approx(1.0, abs=1e-5)
    assert float(metrics.ssim(y, y * 0.5 + 60)) < 0.99
