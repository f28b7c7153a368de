"""Host-side video I/O (codecs are host work, not card work; counterpart of
star_tpu/data/io.py).

Behavioral reference: inference_utils.py (cv2 frame reader returning fps,
ffmpeg libx264 -crf 0 writer with an imageio fallback, [-1,1] preprocessing).
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
from typing import List, Tuple

import numpy as np

from ..utils.logger import get_logger

logger = get_logger()


def load_video(path: str) -> Tuple[np.ndarray, float]:
    """-> (frames [F, H, W, 3] uint8 RGB, fps)."""
    import cv2
    cap = cv2.VideoCapture(path)
    fps = cap.get(cv2.CAP_PROP_FPS)
    total = cap.get(cv2.CAP_PROP_FRAME_COUNT)
    frames: List[np.ndarray] = []
    while len(frames) < total:
        ret, frame = cap.read()
        if not ret or frame is None:
            break
        frames.append(frame[:, :, ::-1])  # BGR -> RGB
    cap.release()
    if not frames:
        raise ValueError(f'no frames decoded from {path}')
    return np.stack(frames), fps


def save_video(frames: np.ndarray, save_dir: str, file_name: str,
               fps: float = 16.0) -> str:
    """frames: [F, H, W, 3] uint8 RGB. Writes lossless-ish h264 via the ffmpeg
    binary when present (reference: inference_utils.py:87-105, -crf 0),
    falling back to imageio."""
    os.makedirs(save_dir, exist_ok=True)
    out_path = os.path.join(save_dir, file_name)
    if shutil.which('ffmpeg'):
        import cv2
        tmp = tempfile.mkdtemp()
        try:
            for i, fr in enumerate(frames):
                cv2.imwrite(os.path.join(tmp, f'{i + 1:06d}.png'),
                            fr[:, :, ::-1])
            tmp_path = os.path.join(save_dir, '.tmp_' + file_name)
            cmd = ['ffmpeg', '-y', '-f', 'image2', '-framerate', str(fps),
                   '-i', os.path.join(tmp, '%06d.png'), '-vcodec', 'libx264',
                   '-preset', 'ultrafast', '-crf', '0', '-pix_fmt', 'yuv420p',
                   tmp_path]
            res = subprocess.run(cmd, capture_output=True)
            if res.returncode != 0:
                logger.error('ffmpeg failed: %s', res.stderr[-500:])
                raise RuntimeError('ffmpeg failed')
            os.replace(tmp_path, out_path)
            return out_path
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    try:
        import imageio
        imageio.mimwrite(out_path, list(frames), fps=fps,
                         codec='libx264', quality=10)
        return out_path
    except (ImportError, ValueError):
        pass
    # last resort: cv2's VideoWriter (mp4v)
    import cv2
    f, h, w, _ = frames.shape
    writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*'mp4v'),
                             fps, (w, h))
    if not writer.isOpened():
        raise RuntimeError(f'no usable video writer for {out_path}')
    for fr in frames:
        writer.write(np.ascontiguousarray(fr[:, :, ::-1]))
    writer.release()
    return out_path


def preprocess(frames: np.ndarray) -> np.ndarray:
    """uint8 [F,H,W,3] -> float32 [-1,1] (inference_utils.py:26-39)."""
    x = frames.astype(np.float32) / 255.0
    return (x - 0.5) / 0.5


def load_video_with_timeout(path: str, timeout: float = 20.0
                            ) -> Tuple[np.ndarray, float]:
    """Decode in a daemon thread with a timeout — corrupt files can hang
    codec libraries (reference: data_video.py:199-214)."""
    import threading
    result: dict = {}

    def _target():
        try:
            result['value'] = load_video(path)
        except Exception as e:  # propagate after join
            result['error'] = e

    th = threading.Thread(target=_target, daemon=True)
    th.start()
    th.join(timeout)
    if th.is_alive():
        raise TimeoutError(f'video decode timed out after {timeout}s: {path}')
    if 'error' in result:
        raise result['error']
    return result['value']
