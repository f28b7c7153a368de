"""One run of one cell, on any device: the traffic driver found by the
traffic file's kind, the end-to-end metrics or (traced) the per-layer
metrics read by their readers, the compared numbers judged against the
cell's limits. run.py adds the look for a card and the result line; the
CPU tests call run_cell directly at tiny sizes."""

from __future__ import annotations

import contextlib
import importlib
import os
import sys

import torch

from . import common, trace as tracing
from .work import LaunchLog


@contextlib.contextmanager
def _no_profile():
    yield None


def _profiler(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == 'cuda':
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return lambda: torch.profiler.profile(activities=acts)


def limits_of(workload: str) -> dict:
    return common.load_json(os.path.join(common.BENCH_DIR, 'limits',
                                         workload + '.json'))['limits']


def per_layer_names(bench: dict, workload: str) -> list[str]:
    """The per-layer metrics this cell reports: those that list it, and
    those without a list whose end-to-end metric the cell reports."""
    e2e = end_to_end_names(bench, workload)
    out = []
    for m in bench['per_layer']:
        cells = m.get('workloads')
        if (workload in cells) if cells is not None else m['moves'] in e2e:
            out.append(m['name'])
    return out


def end_to_end_names(bench: dict, workload: str) -> list[str]:
    return [m['name'] for m in bench['end_to_end']
            if workload in m.get('workloads', [workload])]


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             traced: bool, device, t_process: float, config=None,
             traffic=None, limits=None):
    """-> (result dict without checks, checks). `config`, `traffic` and
    `limits` replace the cell's files (the tests' tiny sizes)."""
    cell, centry, tr = common.find_cell(bench, workload)
    cfg = config or common.load_json(os.path.join(common.ROOT,
                                                  centry['file']))
    tr = traffic or tr
    limits = limits or limits_of(workload)
    driver = importlib.import_module(f'benchmark.drivers.{tr["kind"]}')
    ctx = {'config': cfg, 'traffic': tr, 'device': device, 'seed': seed,
           'seconds': seconds, 'trace': traced, 't_process': t_process,
           'launch_log': LaunchLog(),
           'profile': _profiler(device) if traced else _no_profile}
    out = driver.run(ctx)
    for name, value in out['numbers'].items():
        print(f'reading {name} {value}', file=sys.stderr)
    correct, checks = common.judge(out['numbers'], limits)
    units = {m['name']: m['unit'] for m in bench['end_to_end']
             + bench['per_layer']}
    metrics = {}
    if traced:
        tl = (tracing.from_profiler(out['profile'])
              if out['profile'] is not None else None)
        reading = dict(out, timeline=tl, launches=ctx['launch_log'])
        for name in per_layer_names(bench, workload):
            value = common.metric_reader(name).read(reading)
            if value is not None:
                metrics[name] = common.metric(value, units[name])
    else:
        for name in end_to_end_names(bench, workload):
            value = (out['setup_s'] if name == 'setup_s'
                     else out['peak_bytes'] / 1e9 if name == 'peak_mem_gb'
                     else out['e2e'][name])
            metrics[name] = common.metric(value, units[name])
    if device.type == 'cuda':
        dev = {'platform': 'gpu', 'kind': torch.cuda.get_device_name(device),
               'count': cell['chips'],
               'memory_peak_bytes': max(out['peak_bytes'],
                                        out['setup_peak_bytes'])}
    else:
        dev = {'platform': 'cpu', 'kind': 'cpu', 'count': 1,
               'memory_peak_bytes': 0}
    result = {'correct': correct, 'attempted': out['attempted'],
              'failed': out['failed'], 'metrics': metrics, 'device': dev}
    if traced and tl is not None:
        dev['busy_s'] = tracing.busy_s(tl)
        dev['window_s'] = tl.window_s
        result['breakdown'] = {'device_ops': tracing.top_ops(tl),
                               'idle_gaps': tracing.idle_gaps(tl)}
    result['reference_s'] = out['reference_s']
    return result, checks
