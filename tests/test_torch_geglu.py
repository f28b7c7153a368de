"""K12, the UNet's GEGLU (star_tpu_torch/ops/geglu.py,
csrc/geglu.cu): the plain version against the expression the UNet ran
before, the feed-forward's gradients against eager autograd, the
launcher's arguments and refusals on CUDA-looking CPU tensors (its routing
and its recompute backward are rows of the kernel contract's table,
tests/test_torch_guards.py), the launches per
shape from the full-depth models at narrow widths (chip_smoke.py's
table), and, on a card, the kernel against the plain version bit for bit.
No JAX: the `cuda` cases run on the card with --noconftest."""

import pytest
import torch
import torch.nn.functional as F

import chip_smoke as cs
from star_tpu_torch import ops
from star_tpu_torch.models.unet import blocks
from star_tpu_torch.models.unet.blocks import FeedForwardGEGLU
from star_tpu_torch.ops import _build
from star_tpu_torch.ops import geglu as gg


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    """One intra-op thread: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _old_expression(p):
    """FeedForwardGEGLU's activation as the UNet wrote it before K12."""
    h, gate = p.chunk(2, dim=-1)
    return h * F.gelu(gate.float(), approximate='tanh').to(h.dtype)


def _inputs(rows, inner, dtype, seed=0, device='cpu'):
    g = torch.Generator(device=device).manual_seed(seed)
    # gates over the GELU's whole range: its negative dip, the tanh's
    # polynomial and exponential branches and the saturated tail
    return (torch.randn(rows, 2 * inner, generator=g, device=device) * 3
            ).to(dtype)


# ------------------------------------------------------------------ CPU

@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('lead', [(37,), (2, 3, 5)])
def test_plain_version_is_the_old_expression(dtype, lead):
    p = _inputs(int(torch.tensor(lead).prod()), 24, dtype).view(*lead, 48)
    got = gg.geglu_plain(p)
    assert got.dtype == dtype and got.shape == (*lead, 24)
    assert torch.equal(got, _old_expression(p))


@pytest.mark.parametrize('ranks', [2, 4])
def test_plain_version_on_a_tensor_parallel_shard(ranks):
    """parallel/sharding.py splits proj's value and gate halves each, so a
    rank's p is [its h columns | its gate columns]: the plain version on it
    is the rank's columns of the whole output, bit for bit. A rank's gate
    holds 19 x 32 or more values, whole vectors of PyTorch's CPU GELU: its
    vectorised body and its scalar tail compute tanh differently (one fp32
    bit apart at times), which would show here as a layout fault."""
    inner = 128
    p = _inputs(19, inner, torch.bfloat16)
    whole = _old_expression(p)
    w = inner // ranks
    for r in range(ranks):
        cols = slice(r * w, (r + 1) * w)
        shard = torch.cat([p[:, :inner][:, cols], p[:, inner:][:, cols]], -1)
        assert torch.equal(gg.geglu_plain(shard), whole[:, cols])


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_feedforward_and_its_gradients_equal_eager_autograd(dtype):
    """FeedForwardGEGLU on the CPU (the plain version, which autograd
    differentiates) against the old forward under eager autograd: the
    output and every gradient bit for bit."""
    torch.manual_seed(0)
    ff = FeedForwardGEGLU(16).to(dtype)
    x = (torch.randn(2, 7, 16) * 2).to(dtype).requires_grad_()
    ct = torch.randn(2, 7, 16).to(dtype)

    def grads(forward):
        ff.zero_grad()
        x.grad = None
        out = forward(x)
        out.backward(ct)
        return [out.detach(), x.grad.clone()] + [
            q.grad.clone() for q in ff.parameters()]

    got = grads(ff)
    want = grads(lambda t: ff.out(_old_expression(ff.proj(t))))
    assert len(got) == 6
    for a, b in zip(got, want):
        assert torch.equal(a, b)


class _FakeCuda(torch.Tensor):
    @property
    def is_cuda(self):
        return True


def _fake(*shape, dtype=torch.bfloat16):
    return torch.Tensor._make_subclass(_FakeCuda,
                                       torch.randn(*shape).to(dtype))


class _Library:
    def __init__(self):
        self.calls = []

    def star_geglu(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def library(monkeypatch):
    lib = _Library()
    monkeypatch.setattr(_build, 'lib', lambda: lib)
    monkeypatch.setattr(_build, 'stream_ptr', lambda device: 7)
    return lib


@pytest.mark.parametrize('lead,inner', [((5,), 8), ((2, 3, 11), 1280),
                                        ((1, 4), 2560)])
def test_launch_hands_the_entry_point_rows_and_inner(library, lead, inner):
    p = _fake(*lead, 2 * inner)
    before = ops.launch_counts()['geglu']
    out = gg._launch(p)
    rows = int(torch.tensor(lead).prod())
    assert library.calls == [(p.data_ptr(), out.data_ptr(), rows, inner, 7)]
    assert out.shape == (*lead, inner) and out.dtype == torch.bfloat16
    assert ops.launch_counts()['geglu'] == before + 1


def _refusal_case(case):
    base = torch.zeros(2 * 64 * 2 + 4, dtype=torch.bfloat16)
    return {
        'cpu': torch.zeros(3, 128, dtype=torch.bfloat16),
        'fp32': _fake(3, 128, dtype=torch.float32),
        'strided': _fake(128, 3).t(),
        'inner12': _fake(3, 24),
        'odd': _fake(3, 129),
        'misaligned': torch.Tensor._make_subclass(
            _FakeCuda, base[4:].view(2, 128)),
    }[case]


@pytest.mark.parametrize('case', ['cpu', 'fp32', 'strided', 'inner12', 'odd',
                                  'misaligned'])
def test_launcher_refuses_what_the_kernel_does_not_take(library, case):
    p = _refusal_case(case)
    with pytest.raises(ValueError):
        gg._launch(p)
    assert library.calls == []


def _record_geglu(monkeypatch):
    calls = []
    real = blocks.geglu

    def rec(p):
        calls.append((p.numel() // p.shape[-1], p.shape[-1] // 2))
        return real(p)
    monkeypatch.setattr(blocks, 'geglu', rec)
    return calls


def test_launches_per_shape_from_the_full_depth_models(monkeypatch):
    """The full-depth UNet+ControlNet at narrow widths (32 channels for
    320, tokens 18x24 for 90x160), every GEGLU recorded as (rows, inner)
    and mapped to full width: chip_smoke.py's table of one CFG call, 48
    launches; a train step's forward under remat runs each GEGLU twice
    (the forward, the recompute in the backward), 96."""
    from star_tpu_torch.models.unet.unet import ControlledV2VUNet
    calls = _record_geglu(monkeypatch)
    torch.manual_seed(0)
    unet = ControlledV2VUNet(dim=32, head_dim=16, num_heads_init_temporal=2,
                             context_dim=16).eval()
    x, hint = torch.randn(1, 8, 18, 24, 4), torch.randn(1, 8, 18, 24, 4)
    with torch.no_grad():
        unet(x, torch.tensor([500]), torch.randn(2, 77, 16), hint,
             cfg_pair=True)
    tokens = {432: 14400, 120: 3600, 36: 920, 12: 240}
    widths = {128: 1280, 256: 2560, 512: 5120}

    def table():
        got = {}
        for rows, inner in calls:
            n = next(t for t in tokens if rows % t == 0 and rows // t in
                     (8, 16))
            key = (rows // n * tokens[n], widths[inner])
            got[key] = got.get(key, 0) + 1
        return got
    assert table() == cs.GEGLU_PER_CFG_CALL
    assert cs.GEGLU_PER_CFG_STEP['geglu'] == 48
    assert set(cs.GEGLU_TIMED_SHAPES) <= set(cs.GEGLU_PER_CFG_CALL)

    calls.clear()
    train = ControlledV2VUNet(dim=32, head_dim=16, num_heads_init_temporal=2,
                              context_dim=16, remat=True).train()
    out = train(x, torch.tensor([500]), torch.randn(1, 77, 16), hint)
    assert len(calls) == 48
    out.float().sum().backward()
    assert len(calls) == cs.GEGLU_PER_TRAIN_STEP['geglu'] == 96


# ------------------------------------------------------------------ card

@pytest.mark.cuda
@pytest.mark.parametrize('rows,inner', [(230400, 1280), (57600, 2560),
                                        (14720, 5120), (3840, 5120),
                                        (1001, 1280), (3, 8), (77, 40)])
def test_kernel_matches_the_plain_version_on_the_card(rows, inner):
    """The four UNet shapes of a CFG call, a ragged M and narrow inners."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    p = _inputs(rows, inner, torch.bfloat16, seed=rows, device='cuda')
    out = gg.geglu(p)
    assert out.shape == (rows, inner)
    ulps = cs.geglu_ulps(out, p)
    assert ulps <= 1e-3 * out.numel(), ulps


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['fp32', 'strided', 'inner12'])
def test_launcher_raises_on_the_card(case):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    p = {'fp32': torch.zeros(3, 128, device='cuda'),
         'strided': torch.zeros(128, 3, dtype=torch.bfloat16,
                                device='cuda').t(),
         'inner12': torch.zeros(3, 24, dtype=torch.bfloat16, device='cuda'),
         }[case]
    before = ops.launch_counts()['geglu']
    with pytest.raises(ValueError):
        gg.geglu(p)
    assert ops.launch_counts()['geglu'] == before
