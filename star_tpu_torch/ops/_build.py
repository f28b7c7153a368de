"""Build and load the port's hand-written CUDA kernels.

Every source in `star_tpu_torch/csrc/*.cu` is compiled by its own `nvcc`
process for `sm_90a` (all started together), and the objects are linked
into one shared library with a plain C interface, loaded with ctypes. No
PyTorch header is included, so a build takes seconds. The library lives in
`build/kernels/` at the root of the checkout, named by a hash of the sources
and flags, and is built at first use — never when a module is imported.

Each C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `check()` raises on anything but 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(_PKG), 'build', 'kernels')
ARCH_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a']
NVCC_FLAGS = ['-std=c++17', '-O3', '-Xcompiler', '-fPIC', '-lineinfo']

_lock = threading.Lock()
_lib = None

P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong
Fl = ctypes.c_float

# C signatures of the entry points in csrc/ (all return cudaError_t as int)
_SIGNATURES = {
    # q, k, v, o, lse (or null), B, H, Sq, Sk, kv_valid, q/k/v/o batch
    # strides, q/k/v/o row strides, c (= scale*log2e), stream
    'star_flash_fwd_d64': [P, P, P, P, P, I, I, I, I, I, L, L, L, L,
                           I, I, I, I, Fl, P],
    # q, k, v, o, B, H, Sq, Sk, kv_valid, q/k/v/o batch strides,
    # q/k/v/o row strides, c (= scale*log2e), stream
    'star_flash_fwd_d512': [P, P, P, P, I, I, I, I, I, L, L, L, L,
                            I, I, I, I, Fl, P],
    # q, k, v, o, dout, lse, dq, dk, dv, workspace, B, H, Sq, Sk,
    # kv_valid, q-side / k-side batch strides, row stride, scale, stream
    'star_flash_bwd_d64': [P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, L,
                           L, I, Fl, P],
    # q, k, v, o, B, F, N, H, scale, stream
    'star_temporal_attention': [P, P, P, P, I, I, I, I, Fl, P],
    # x, a, b, w [3, Cout, C], bias, residual, out, sum, sumsq, B, F, N, C,
    # Cout, want_stats, per_frame, P, FT, NW, slab bytes, weight stages,
    # grid, smem, stream
    'star_fused_gn_silu_tconv3': [P, P, P, P, P, P, P, P, P, I, I, I, I, I,
                                  I, I, I, I, I, I, I, I, I, P],
    # x, a, b, w, bias, residual, out, sum, sumsq, N, H, W, C, Cout,
    # want_stats, grid, stream
    'star_conv3x3': [P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, P],
    # x, w [Cout, 16, C], bias, out, sum, sumsq, N, H, W, C, Cout,
    # want_stats, phase offsets [4], phase strides [3], tap bytes [16],
    # grid, stream
    'star_upsample_conv2x': [P, P, P, P, P, P, I, I, I, I, I, I, P, P, P, I,
                             P],
    # p00, p01, p10, p11, out, sum, sumsq, N, H, W, C, want_stats, stream
    'star_interleave2x2': [P, P, P, P, P, P, P, I, I, I, I, I, P],
    # x, cos, sin, scale, bias, out, rows, S, H, eps, stream
    'star_qk_ln_rope': [P, P, P, P, P, P, L, I, I, Fl, P],
    # x, ct, cos, sin, scale, dx, partials (or null), rows, S, H, eps,
    # fold_scale, stream
    'star_qk_ln_rope_bwd': [P, P, P, P, P, P, P, L, I, I, Fl, Fl, P],
    # x, scale, bias, gate_w (or null), params bf16, out, rows, C, eps,
    # stream
    'star_fused_ln': [P, P, P, P, I, P, L, I, Fl, P],
    # y, resid, scale, bias, gate_w (or null), params bf16, out, xr, rows,
    # C, eps, stream
    'star_fused_resid_ln': [P, P, P, P, P, I, P, P, L, I, Fl, P],
    # p [rows, 2*inner], out [rows, inner], rows, inner, stream
    'star_geglu': [P, P, L, I, P],
    # x, partials, sum, sumsq (or null), scale, bias, params bf16, mean,
    # a, b (bf16, or null), N, R, C, groups, eps, k, max slabs, SMs, stream
    'star_gn_stats': [P, P, P, P, P, P, I, P, P, P, L, L, I, I, Fl, I, I, I,
                      P],
    # x, mean, a, b, y, N, R, C, k, silu, SMs, stream
    'star_gn_apply': [P, P, P, P, P, L, L, I, I, I, I, P],
}


def nvcc_path() -> str:
    for cand in (os.environ.get('NVCC'), shutil.which('nvcc'),
                 '/usr/local/cuda/bin/nvcc'):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError('nvcc not found: the CUDA kernels are built on a '
                       'machine with the CUDA toolkit')


def sources() -> list[str]:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith('.cu'))


def _digest(srcs: list[str]) -> str:
    h = hashlib.sha256(' '.join(ARCH_FLAGS + NVCC_FLAGS).encode())
    for s in srcs + sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                           if f.endswith('.cuh')):
        with open(s, 'rb') as fh:
            h.update(os.path.basename(s).encode() + fh.read())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> str:
    """Compile every csrc/*.cu in parallel and link one .so; returns its
    path. Reuses a library built from the same sources and flags."""
    srcs = sources()
    tag = _digest(srcs)
    so = os.path.join(BUILD_DIR, f'libstar_kernels_{tag}.so')
    if os.path.exists(so):
        return so
    nvcc = nvcc_path()
    os.makedirs(BUILD_DIR, exist_ok=True)
    objs, procs = [], []
    for s in srcs:
        obj = os.path.join(BUILD_DIR, f'{tag}_{os.path.basename(s)}.o')
        cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, '-c', s, '-o', obj]
        if verbose:
            cmd.insert(1, '-Xptxas=-v')
        procs.append((s, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True)))
        objs.append(obj)
    errors = []
    for s, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f'{os.path.basename(s)}:\n{out}')
        elif verbose and out:
            print(out, flush=True)
    if errors:
        raise RuntimeError('nvcc failed:\n' + '\n'.join(errors))
    tmp = so + f'.{os.getpid()}.tmp'
    link = subprocess.run([nvcc, *ARCH_FLAGS, '-shared', '-o', tmp, *objs],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if link.returncode != 0:
        raise RuntimeError('nvcc link failed:\n' + link.stdout)
    os.replace(tmp, so)
    return so


def lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device: the persistent kernels'
    grid (a CPU-looking device in the tests gets the H100's 132)."""
    import torch
    if getattr(device, 'type', None) != 'cuda':
        return 132
    return _sms(device.index if device.index is not None
                else torch.cuda.current_device())


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f'{name}: CUDA launch failed with error {err}')
