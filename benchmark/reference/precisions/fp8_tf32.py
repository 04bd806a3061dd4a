"""The control of a model stated in bfloat16 with float32 heads: one
precision below it.  Wherever the model rounds to bfloat16 (its working
dtype) the control rounds to float8 under a per-tensor scale, e4m3 on the
way forward and e5m2 on the gradient on the way back (float8 training's two
formats); the heads, stated in float32 with TF32 off, run with TF32 on.  A
float8 product is exact in TF32, so TF32 adds nothing inside the backbone."""

import torch

TF32 = True


def _round8(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` rounded to a float8 ``dtype`` under a per-tensor scale (its
    largest magnitude at the format's largest finite value), in float32."""
    scale = x.abs().amax().clamp_min(1e-30) / torch.finfo(dtype).max
    return (x / scale).to(dtype).to(torch.float32) * scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, grad):
        return _round8(grad, torch.float8_e5m2)


def low(x: torch.Tensor) -> torch.Tensor:
    """A tensor at a point where the model rounds it to bfloat16."""
    return _Fp8.apply(x)
