"""Temporal sliding-window chunking of the denoiser
(counterpart of star_tpu/pipeline/chunking.py).

50%-overlap windows of max_chunk_len frames, each denoised independently per
solver step and stitched by cutting half the overlap from each side.
Equal-length windows fold into the batch dimension (one UNet call for all).
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch


def sliding_windows_1d(length: int, window_size: int,
                       overlap_size: int) -> List[Tuple[int, int]]:
    """The tail window absorbs up to 1.25x window_size frames."""
    stride = window_size - overlap_size
    ind = 0
    coords = []
    while ind < length:
        if ind + window_size * 1.25 >= length:
            coords.append((ind, length))
            break
        coords.append((ind, ind + window_size))
        ind += stride
    return coords


def make_chunks(f_num: int, max_chunk_len: int, interp_f_num: int = 0,
                chunk_overlap_ratio: float = 0.5) -> List[Tuple[int, int]]:
    max_o_len = max_chunk_len * chunk_overlap_ratio
    chunk_len = int((max_chunk_len - 1) // (1 + interp_f_num)
                    * (interp_f_num + 1) + 1)
    o_len = int((max_o_len - 1) // (1 + interp_f_num) * (interp_f_num + 1) + 1)
    return sliding_windows_1d(f_num, chunk_len, o_len)


def stitch_slices(chunk_inds: Sequence[Tuple[int, int]]):
    """Per-chunk (start, stop) of the region each chunk contributes to the
    stitched output."""
    if len(chunk_inds) == 1:
        s, e = chunk_inds[0]
        return [(0, e - s)]
    o_len = chunk_inds[0][1] - chunk_inds[1][0]
    cut = o_len // 2
    spans = []
    for i, (s, e) in enumerate(chunk_inds):
        cur = e - s
        if i == 0:
            spans.append((0, cur + cut - o_len))
        elif i == len(chunk_inds) - 1:
            spans.append((cut, cur))
        else:
            spans.append((cut, cur + cut - o_len))
    return spans


def chunked_x0_fn(denoise_chunk: Callable[[torch.Tensor, torch.Tensor, int],
                                          torch.Tensor],
                  hint: torch.Tensor,
                  chunk_inds: Sequence[Tuple[int, int]]):
    """Whole-video x0 function from a per-chunk denoiser
    denoise_chunk(xt_chunk, hint_chunk, t) -> x0_chunk; xt/hint are
    [B, F, H, W, C] and chunking is over F."""
    chunk_inds = list(chunk_inds)
    spans = stitch_slices(chunk_inds)

    def x0_fn(xt: torch.Tensor, t: int) -> torch.Tensor:
        if len(chunk_inds) == 1:
            return denoise_chunk(xt, hint, t)
        lengths = [e - s for s, e in chunk_inds]
        results: List[torch.Tensor | None] = [None] * len(chunk_inds)
        b = xt.shape[0]
        for ln in sorted(set(lengths)):
            idxs = [i for i, l in enumerate(lengths) if l == ln]
            xs = torch.cat([xt[:, chunk_inds[i][0]:chunk_inds[i][1]]
                            for i in idxs], dim=0)
            hs = torch.cat([hint[:, chunk_inds[i][0]:chunk_inds[i][1]]
                            for i in idxs], dim=0)
            x0s = denoise_chunk(xs, hs, t)
            for k, i in enumerate(idxs):
                results[i] = x0s[k * b:(k + 1) * b]
        pieces = [results[i][:, s0:s1] for i, (s0, s1) in enumerate(spans)]
        return torch.cat(pieces, dim=1)

    return x0_fn
