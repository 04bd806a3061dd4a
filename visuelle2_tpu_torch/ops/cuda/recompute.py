"""The autograd function the kernel wrappers share: the kernel forward, and
as the backward autograd of the plain version recomputed from the saved
inputs (the JAX Pallas kernels have no VJP; XLA differentiates their plain
formulas, which this is the port of).  The backward launches no kernel and
keeps no activation of the forward: only its inputs are saved.
"""

from __future__ import annotations

from typing import Callable

import torch


def recompute_backward(name: str, forward: Callable, plain: Callable, n_static: int = 0):
    """A ``torch.autograd.Function`` subclass named ``name`` (its nodes are
    ``<name>Backward``) whose ``apply(*static, *tensors)`` returns
    ``forward(*static, *tensors)`` and whose backward is autograd of
    ``plain(*static, *tensors)``; the first ``n_static`` arguments are not
    tensors.  Its ``run`` takes the same arguments and goes through the
    function only where grad is enabled and a tensor needs a gradient, so
    an eval forward runs ``forward`` alone."""

    def fwd(ctx, *args):
        ctx.static = args[:n_static]
        ctx.save_for_backward(*args[n_static:])
        return forward(*args)

    def bwd(ctx, *douts):
        needs = ctx.needs_input_grad[n_static:]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, needs)]
            outs = plain(*ctx.static, *inputs)
            wanted = [t for t, n in zip(inputs, needs) if n]
            grads = iter(torch.autograd.grad(outs, wanted, douts, allow_unused=True))
        return (*(None,) * n_static, *(next(grads) if n else None for n in needs))

    def run(*args):
        if torch.is_grad_enabled() and any(t.requires_grad for t in args[n_static:]):
            return function.apply(*args)
        return forward(*args)

    function = type(name, (torch.autograd.Function,), {
        "__doc__": f"{name}: the kernel forward; autograd of the plain version, "
                   "recomputed from the saved inputs, backward.",
        "forward": staticmethod(fwd), "backward": staticmethod(bwd),
        "run": staticmethod(run)})
    return function
