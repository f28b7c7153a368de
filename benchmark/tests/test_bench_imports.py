"""The import guard: no file of the benchmark imports a forbidden
top-level name, the reference imports nothing of the program or of the
harness, and a process that has run the harness's code holds no
forbidden module."""

import ast
import os
import subprocess
import sys

from benchmark.harness import common

BENCH = os.path.join(common.ROOT, 'benchmark')


def imported_names(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def py_files(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith('.py'):
                yield os.path.join(d, f)


def test_no_forbidden_top_level_name():
    bad = [(p, n) for p in py_files(BENCH) for n in imported_names(p)
           if n.split('.')[0] in common.FORBIDDEN]
    assert not bad, bad


def test_forbidden_names_compare_whole():
    mods = {'star_tpu_torch': 1, 'star_tpu_torch.ops': 1, 'jaxtyping': 1}
    assert common.forbidden_modules(mods) == []
    assert common.forbidden_modules({'star_tpu.ops': 1, 'jax': 1}) == [
        'jax', 'star_tpu.ops']


def test_reference_imports_neither_program_nor_harness():
    for p in py_files(os.path.join(BENCH, 'reference')):
        for n in imported_names(p):
            top = n.split('.')[0]
            assert top in ('torch', 'numpy', 'math', '__future__'), (p, n)


def test_a_process_running_the_harness_holds_no_forbidden_module():
    code = ('import sys; sys.path.insert(0, %r);'
            'import benchmark.harness.cell, benchmark.drivers.sr_clips,'
            'benchmark.control;'
            'import star_tpu_torch.cli.inference_sr;'
            'from benchmark.harness import common;'
            'print(common.forbidden_modules())' % common.ROOT)
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == '[]'
