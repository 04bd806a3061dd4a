"""Model registry, counterpart of ``visuelle2_tpu/models/registry.py``.

``build(name, device=..., generator=..., **overrides)`` returns an eval-mode
``nn.Module`` on ``device`` (``cuda`` unless the caller passes one; see
``_device.py``), its weights drawn from ``generator`` with the JAX package's
initializers: lecun-normal Dense/Conv kernels, zero biases (``_Weights``
biases at their ``bias_init``, +2.0 for the gated_v2 gates), unit norms,
U(±1/√H) GRU weights.  The seq2seq family (``gtm``, ``m4ft``,
``gated_v1`` … ``gated_v4``) and the CrossAttnRNN family
(``cross_attn_rnn_21``, ``cross_attn_rnn_210``, ``cross_attn_rnn_demand``),
the VISUELLE-1 GTM (``gtm_v1``, its frozen tower channels_last like every
backbone) and the statistical baselines (``oracle``: a parameter-free
``Oracle`` whose tensors live on ``device``) make the reference's 11.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from visuelle2_tpu_torch._device import resolve_device
from visuelle2_tpu_torch.models.cross_attn_rnn import (
    CrossAttnRNN21,
    CrossAttnRNN210,
    CrossAttnRNNDemand,
)
from visuelle2_tpu_torch.models.encoders import ImagePatchEncoder, ImagePooledEncoder
from visuelle2_tpu_torch.models.gtm_v1 import GTMv1, _FrozenImageTower
from visuelle2_tpu_torch.models.norms import BatchNorm1d
from visuelle2_tpu_torch.models.oracle import Oracle
from visuelle2_tpu_torch.models.resnet import BatchNorm
from visuelle2_tpu_torch.models.seq2seq import VARIANTS, Seq2SeqForecaster
from visuelle2_tpu_torch.ops.attention import _Weights
from visuelle2_tpu_torch.ops.gru import GRUParams

# Reference dims: 512 for CrossAttnRNN; emb 32 / hidden 64 / heads 4 /
# layers 1 for the GTM family.
_CROSS_ATTN_DEFAULTS = dict(attention_dim=512, embedding_dim=512, hidden_dim=512)
_GTM_DEFAULTS = dict(embedding_dim=32, hidden_dim=64, num_heads=4, num_layers=1)

_CROSS_ATTN = {
    "cross_attn_rnn_21": CrossAttnRNN21,
    "cross_attn_rnn_210": CrossAttnRNN210,
    "cross_attn_rnn_demand": CrossAttnRNNDemand,
}


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator):
    # flax lecun_normal: truncated normal (±2σ) of variance 1/fan_in; the
    # stddev correction 0.8796 undoes the truncation's shrinkage.
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        tmp = torch.empty(w.shape, dtype=torch.float32)
        nn.init.trunc_normal_(tmp, 0.0, 1.0, -2.0, 2.0, generator=generator)
        w.copy_(tmp * std)


def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Draw every parameter of ``model`` from ``generator`` (on the CPU)."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Linear):
                _lecun_normal_(mod.weight, mod.in_features, generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.Conv2d):
                fan_in = mod.in_channels * mod.kernel_size[0] * mod.kernel_size[1]
                _lecun_normal_(mod.weight, fan_in, generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.Embedding):
                # flax Embed: variance_scaling(1, fan_in, normal, out_axis=0)
                mod.weight.normal_(0.0, 1.0 / math.sqrt(mod.num_embeddings),
                                   generator=generator)
            elif isinstance(mod, (nn.LayerNorm, BatchNorm, BatchNorm1d)):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, GRUParams):
                bound = 1.0 / math.sqrt(mod.hidden_dim)
                for p in (mod.w_i, mod.w_h, mod.b_i, mod.b_h):
                    p.uniform_(-bound, bound, generator=generator)
            elif isinstance(mod, _Weights):
                _lecun_normal_(mod.kernel, mod.kernel.shape[0], generator)
                if mod.bias is not None:
                    mod.bias.fill_(mod.bias_init)


def model_names():
    """Every name ``build`` knows: the reference's 11 models."""
    return sorted([*_CROSS_ATTN, *VARIANTS, "gtm_v1", "oracle"])


def build(name: str, *, device=None, generator: Optional[torch.Generator] = None,
          **overrides):
    """Build a registry model in eval mode on ``device``.

    ``generator`` (default: seeded with 0) draws the initial weights;
    ``convert.load_jax_variables`` replaces them with a JAX model's.
    ``oracle`` takes ``method`` and ``use_teacher_forcing`` and has no
    weights.
    """
    if name == "oracle":
        return Oracle(device=device, **overrides)
    if name == "gtm_v1":
        make = lambda: GTMv1(**{**_GTM_DEFAULTS, **overrides})
    elif name in _CROSS_ATTN:
        make = lambda: _CROSS_ATTN[name](**{**_CROSS_ATTN_DEFAULTS, **overrides})
    elif name in VARIANTS:
        make = lambda: Seq2SeqForecaster(variant=name, **{**_GTM_DEFAULTS, **overrides})
    else:
        raise KeyError(f"unknown model {name!r}; known: {model_names()}")
    dev = resolve_device(device)
    model = make()
    init_parameters(model, generator or torch.Generator().manual_seed(0))
    for mod in model.modules():
        if isinstance(mod, (ImagePatchEncoder, ImagePooledEncoder, _FrozenImageTower)):
            mod.to(memory_format=torch.channels_last)
    return model.to(dev).eval()
