"""The one kernel contract of star_tpu_torch/ops (stated in ops/__init__.py):
the launch counter, the dispatch of a kernel's op by device and grad, and
the recompute backward shared by the kernels that have no backward
kernel.
"""

from __future__ import annotations

import sys

import torch

# launches of each kernel since ops.reset_launch_counts(): each launcher
# adds one after its entry point returns
COUNTS: dict[str, int] = {}


def kernels(*names: str) -> None:
    """Declare the launch counts of a module's kernels (ops.KERNELS)."""
    for name in names:
        COUNTS.setdefault(name, 0)


def needs_grad(*args) -> bool:
    """Grad mode is on and a tensor among `args` requires grad: the call is
    recorded."""
    return torch.is_grad_enabled() and any(
        isinstance(a, torch.Tensor) and a.requires_grad for a in args)


def refuse_grad(name: str, *tensors) -> None:
    """For the kernels that have no backward (K2 d=512, K6, K7, K8, and
    K9's forward launcher, which its own Function wraps): raise rather than
    return a result cut off from autograd when grad mode is on and an
    input requires grad."""
    if needs_grad(*tensors):
        raise RuntimeError(f'{name} has no backward kernel: call it under '
                           'torch.no_grad() or on inputs that do not '
                           'require grad')


class Kernel:
    """A kernel's op, declared in its module as `Kernel(__name__, launch,
    plain)` and called with the arguments the launcher and the plain
    version both take, positionally, the first a tensor: a CUDA one runs
    `launch`, a CPU one `plain`. Both are names looked up in the module
    when the call is made, so that a replacement set on the module after
    import is the one called. With `recompute`, a CUDA call under grad goes
    through `_Recompute`; without it, the launcher refuses the grad."""

    __slots__ = ('module', 'launch', 'plain', 'recompute')

    def __init__(self, module: str, launch: str, plain: str,
                 recompute: bool = False):
        self.module = sys.modules[module]
        self.launch, self.plain, self.recompute = launch, plain, recompute

    def __call__(self, *args):
        if args[0].is_cuda:
            if self.recompute and needs_grad(*args):
                return _Recompute.apply(self, *args)
            return getattr(self.module, self.launch)(*args)
        return getattr(self.module, self.plain)(*args)


class _Recompute(torch.autograd.Function):
    """The backward of every kernel that has no backward kernel (K4, K5,
    K10, K11, K12, K13): the forward launches the kernel and saves the
    tensor inputs; the backward recomputes the plain version from them
    under grad and differentiates it, as the JAX package's custom VJPs
    recompute through their references. A gradient goes to exactly the
    inputs whose needs_input_grad is set, None elsewhere. The op returns a
    tensor or a tuple of tensors and Nones (K11's (normed, xr); K5's output
    with its threaded statistics, whose cotangents reach the statistics it
    was given)."""

    @staticmethod
    def forward(ctx, op, *args):
        ctx.op = op
        ctx.where = [i for i, a in enumerate(args)
                     if isinstance(a, torch.Tensor)]
        ctx.args = [None if isinstance(a, torch.Tensor) else a for a in args]
        ctx.save_for_backward(*(args[i] for i in ctx.where))
        return getattr(op.module, op.launch)(*args)

    @staticmethod
    def backward(ctx, *cts):
        need = ctx.needs_input_grad[1:]
        args, live = list(ctx.args), []
        for i, t in zip(ctx.where, ctx.saved_tensors):
            args[i] = t.detach().requires_grad_(need[i])
            if need[i]:
                live.append(args[i])
        with torch.enable_grad():
            outs = getattr(ctx.op.module, ctx.op.plain)(*args)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, ct) for o, ct in zip(outs, cts)
                 if o is not None and o.requires_grad]
        grads = iter(torch.autograd.grad([o for o, _ in pairs], live,
                                         [ct for _, ct in pairs],
                                         allow_unused=True))
        return (None, *(next(grads) if n else None for n in need))
