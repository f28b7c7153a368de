"""Minimal webdataset-style tar-shard reader (counterpart of
star_tpu/data/webds.py; host-side).

Behavioral reference: SAT/sgm webdataset VideoDataset / SFTDataset
(cogvideox-based/sat/data_video.py:320-457; sgm/webds.py) — training streams
{key.mp4, key.txt, key.json} samples from tar shards. The webdataset package
isn't in this image, so this is a dependency-free tarfile implementation of
the same sample-grouping convention, with rank-strided shard assignment.
"""

from __future__ import annotations

import io
import json
import os
import tarfile
from typing import Dict, Iterator, List, Sequence

import numpy as np


def _group_members(tf: tarfile.TarFile):
    """Yield dicts of {ext: bytes} grouped by sample key (webdataset
    convention: files sharing the basename before the first dot)."""
    current_key = None
    sample: Dict[str, bytes] = {}
    for member in tf:
        if not member.isfile():
            continue
        base = os.path.basename(member.name)
        key, _, ext = base.partition('.')
        if current_key is not None and key != current_key and sample:
            yield current_key, sample
            sample = {}
        current_key = key
        data = tf.extractfile(member)
        if data is not None:
            sample[ext] = data.read()
    if sample:
        yield current_key, sample


def _decode(ext: str, raw: bytes):
    if ext in ('txt', 'text'):
        return raw.decode('utf-8')
    if ext == 'json':
        return json.loads(raw)
    if ext in ('mp4', 'avi', 'mkv', 'webm'):
        import cv2
        import tempfile
        with tempfile.NamedTemporaryFile(suffix=f'.{ext}') as f:
            f.write(raw)
            f.flush()
            cap = cv2.VideoCapture(f.name)
            frames = []
            while True:
                ret, fr = cap.read()
                if not ret:
                    break
                frames.append(fr[:, :, ::-1])
            cap.release()
        return np.stack(frames) if frames else None
    if ext in ('npy',):
        return np.load(io.BytesIO(raw))
    return raw


class TarVideoDataset:
    """Streams decoded samples from .tar shards.

    shards: list of tar paths; assigned rank-strided across processes like
    the reference's webdataset url splitting.

    Round-2 features mirroring the reference loader (sgm/webds.py shard
    shuffling + buffered sample shuffle; data_video.py:320-457 resumable
    iteration):
      * shuffle_seed: per-epoch deterministic shard-order shuffle
      * shuffle_buffer: webdataset-style streaming shuffle — fill a buffer of
        N samples, emit a random one, refill
      * state_dict()/load_state_dict(): resume mid-epoch at (epoch,
        shard index, sample index). With shuffle_buffer <= 1 a resumed
        stream is exactly deterministic. With a shuffle buffer, resume is
        APPROXIMATE: state records the raw-stream position, which runs up
        to `shuffle_buffer` samples ahead of what the consumer has seen, so
        buffered-but-unemitted samples are skipped and the shuffle RNG
        restarts — acceptable for training-loader semantics (the reference's
        webdataset resume has the same property).
    """

    def __init__(self, shards: Sequence[str], process_index: int = 0,
                 process_count: int = 1, decode: bool = True,
                 shuffle_seed: int | None = None, shuffle_buffer: int = 0):
        self.shards: List[str] = sorted(shards)[process_index::process_count]
        self.decode = decode
        self.shuffle_seed = shuffle_seed
        self.shuffle_buffer = shuffle_buffer
        self._epoch = 0
        self._shard_idx = 0
        self._sample_idx = 0

    # ---------------------------------------------------------------- state
    def state_dict(self) -> Dict[str, int]:
        return {'epoch': self._epoch, 'shard_idx': self._shard_idx,
                'sample_idx': self._sample_idx}

    def load_state_dict(self, state: Dict[str, int]) -> None:
        self._epoch = int(state['epoch'])
        self._shard_idx = int(state['shard_idx'])
        self._sample_idx = int(state['sample_idx'])

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch
        self._shard_idx = 0
        self._sample_idx = 0

    # ------------------------------------------------------------- iteration
    def _epoch_shards(self) -> List[str]:
        shards = list(self.shards)
        if self.shuffle_seed is not None:
            rng = np.random.RandomState(self.shuffle_seed + self._epoch)
            rng.shuffle(shards)
        return shards

    def _raw_iter(self) -> Iterator[Dict]:
        """Position-tracked sample stream (pre shuffle-buffer)."""
        shards = self._epoch_shards()
        while self._shard_idx < len(shards):
            shard = shards[self._shard_idx]
            skip = self._sample_idx
            with tarfile.open(shard) as tf:
                for n, (key, sample) in enumerate(_group_members(tf)):
                    if n < skip:
                        continue
                    out = {'__key__': key, '__shard__': shard}
                    for ext, raw in sample.items():
                        out[ext] = _decode(ext, raw) if self.decode else raw
                    self._sample_idx = n + 1
                    yield out
            self._shard_idx += 1
            self._sample_idx = 0
        self._epoch += 1
        self._shard_idx = 0
        self._sample_idx = 0

    def __iter__(self) -> Iterator[Dict]:
        if self.shuffle_buffer <= 1:
            yield from self._raw_iter()
            return
        rng = np.random.RandomState(
            (self.shuffle_seed or 0) * 10007 + self._epoch)
        buf: List[Dict] = []
        for sample in self._raw_iter():
            buf.append(sample)
            if len(buf) >= self.shuffle_buffer:
                yield buf.pop(rng.randint(len(buf)))
        while buf:
            yield buf.pop(rng.randint(len(buf)))
