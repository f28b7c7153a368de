"""The benchmark of star_tpu_torch: one cell, one run, one result line.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

Runs from the root of a checkout on a machine with the cards the cell
asks for. Set-up builds the cell's models at their published sizes on
weights drawn from the seed (and the kernels, into build/ inside the
checkout, on the first run there), warms the cell's shapes, then the
window runs the cell's traffic for S seconds. With --trace 0 the result
holds the cell's end-to-end metrics, with --trace 1 its per-layer metrics
(the window under torch.profiler). After the window the output of the
timed path is compared with the plain float32 reference (`checks`).
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# caches of the program and its libraries stay inside the checkout
for var, sub in (('TRITON_CACHE_DIR', 'triton'),
                 ('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                 ('CUDA_CACHE_PATH', 'cuda_cache')):
    os.environ[var] = os.path.join(ROOT, 'build', 'bench_cache', sub)
sys.path.insert(0, ROOT)

from benchmark.harness import common  # noqa: E402

T_PROCESS = common.process_start_time()


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    bench = common.load_json(os.path.join(ROOT, 'BENCHMARK.json'))
    cell, _, _ = common.find_cell(bench, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell['chips']:
        print(f'{args.workload} needs {cell["chips"]} CUDA card(s); found '
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}'
              ': no result', file=sys.stderr)
        return 2
    from benchmark.harness import cell as cellrun
    result, checks = cellrun.run_cell(
        bench, args.workload, args.seed, args.seconds, bool(args.trace),
        torch.device('cuda', 0), T_PROCESS)
    found = common.forbidden_modules()
    if found:
        print('forbidden modules loaded: ' + ', '.join(found),
              file=sys.stderr)
        return 3
    common.emit(result, checks)
    return 0


if __name__ == '__main__':
    sys.exit(main())
