"""What every cell shares: the benchmark's files found by name, the
process clock, the device record, the import guard, the judge of the
compared numbers and the result line."""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH_DIR = os.path.join(ROOT, 'benchmark')

# top-level module names that may not be loaded in a run (compared whole:
# star_tpu_torch is the program, star_tpu the JAX package)
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'star_tpu', 'tools')

# H100 SXM, dense, NVIDIA's data sheet
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def process_start_time() -> float:
    """The process's start on time.time()'s clock (from /proc), or the
    import of this module where /proc does not say."""
    try:
        with open('/proc/self/stat') as f:
            fields = f.read().rsplit(')', 1)[1].split()
        ticks = os.sysconf('SC_CLK_TCK')
        start_after_boot = int(fields[19]) / ticks
        with open('/proc/uptime') as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + start_after_boot
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.time()


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def find_cell(bench: dict, workload: str) -> tuple[dict, dict, dict]:
    """(workload entry, config entry, traffic dict) of a cell by name."""
    cells = {w['name']: w for w in bench['workloads']}
    if workload not in cells:
        raise SystemExit(f'unknown workload {workload!r}; BENCHMARK.json has '
                         f'{sorted(cells)}')
    cell = cells[workload]
    config = {c['name']: c for c in bench['configs']}[cell['config']]
    traffic = load_json(os.path.join(BENCH_DIR, 'traffic',
                                     cell['traffic'] + '.json'))
    return cell, config, traffic


def load_module(path: str, name: str):
    """Import a file of the benchmark by its path (metric readers are
    named after their metric, dots included)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """metrics/<name>.py, or where there is none the reader of the name's
    quantity, metrics/<part before the first dot>.py (`mfu.train` and
    `mfu.sr` both read as `mfu.py`)."""
    path = os.path.join(BENCH_DIR, 'metrics', name + '.py')
    if not os.path.exists(path):
        path = os.path.join(BENCH_DIR, 'metrics',
                            name.split('.', 1)[0] + '.py')
    return load_module(path, 'metric_' + name.replace('.', '_'))


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name is a forbidden one."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules if m.split('.', 1)[0] in FORBIDDEN})


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each number that has a limit against it (at most the limit passes;
    a missing or non-finite number fails). Returns (correct, checks)."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = value is not None and math.isfinite(value) and value <= limit
        ok = ok and good
        checks[name] = {'value': value, 'limit': limit}
    return ok, checks


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of operations over
    the bf16 peak and bytes over the memory peak."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)


def metric(value: float, unit: str) -> dict:
    return {'value': value, 'unit': unit}


def emit(result: dict, checks: dict) -> None:
    """The compared numbers as the last lines on standard error, then the
    result as the last line on standard output, the checks last in it."""
    for name, c in checks.items():
        print(f'check {name} {c["value"]} limit {c["limit"]}',
              file=sys.stderr, flush=True)
    line = dict(result)
    line['checks'] = checks
    print(json.dumps(line), flush=True)


def free(device) -> None:
    """Collect garbage and hand the allocator's cached blocks back to the
    card."""
    import gc
    gc.collect()
    if device.type == 'cuda':
        import torch
        torch.cuda.empty_cache()
