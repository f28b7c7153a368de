"""On the card only (marker `cuda`; skipped here): the trace reduction
reads a real profile, with its kernels on the device's timeline and the
host's ranges kept apart; the float8 control rounds on the card as on the
host.

    python -m pytest benchmark/tests/test_bench_cuda.py -m cuda -q"""

import pytest
import torch

from benchmark.harness import trace
from benchmark.reference import prims


def need_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')


@pytest.mark.cuda
def test_profile_of_the_card_reduces():
    need_card()
    x = torch.randn(2048, 2048, device='cuda')
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function('window'):
            for _ in range(5):
                x = x @ x / 2048.0
            torch.cuda.synchronize()
    tl = trace.from_profiler(prof)
    assert tl.device and 'window' not in {d[0] for d in tl.device}
    assert 0.0 < trace.busy_s(tl) <= tl.window_s
    assert trace.top_ops(tl)


@pytest.mark.cuda
def test_float8_control_on_the_card():
    need_card()
    x = torch.linspace(-3, 3, 1001, device='cuda')
    p = prims.Precision(fp8=True)
    assert torch.equal(p.q(x).cpu(), p.q(x.cpu()))
