"""GTM-family transformer forecaster, counterpart of
``visuelle2_tpu/models/seq2seq.py``.

One configurable ``Seq2SeqForecaster``; the ``VARIANTS`` table pins each
reference model (gtm, m4ft, gated_v1 … gated_v4): its encoder style, fusion
network, trend encoder and decoder.  Non-AR and AR, with the ``use_text`` /
``use_img`` ablations of the JAX module: an ablated modality's encoder is
not built and the fusion drops or zeroes its term.

Decode semantics:

* non-AR: a single fused token cross-attends over the 52-step trend memory,
  then ``Linear(H -> out_len)``.
* AR: an ``out_len``-token target (position 0 = fused context, rest zeros)
  with sinusoidal positions and a causal mask, ``Linear(H -> 1)``.

The trend encoder has 4 heads unless it is the gated (v2) one, which takes
``num_heads``.  gated_v2 runs the fused gated-MHA kernel three times per
forward (two trend-encoder layers, one decoder cross-attention) and gated_v4
the fused gated residual twice.  Eval mode only: training arrives with the
training slice.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from visuelle2_tpu_torch.models.base import VocabSizes, flatten_windows, repeat_windows
from visuelle2_tpu_torch.models.encoders import (
    AttributeEncoder,
    DummyEmbedder,
    GTrendEmbedder,
    ImagePooledEncoder,
    SalesEncoder,
    TemporalEmbedder,
)
from visuelle2_tpu_torch.models.fusion import (
    GTMFusionNetwork,
    M4FTFusionNetwork,
    PureGatedFusionNetwork,
    ResidualGatedFusionNetwork,
    TARGFusionNetwork,
    TextGuidedFusionNetwork,
)
from visuelle2_tpu_torch.ops.masks import causal_mask
from visuelle2_tpu_torch.ops.positional import PositionalEncoding
from visuelle2_tpu_torch.ops.transformer import TransformerDecoder


@dataclasses.dataclass(frozen=True)
class Seq2SeqVariant:
    """Which reference model this configuration reproduces."""

    encoder_style: str   # "gtm" (stack-text) | "m4ft" (projected-to-hidden)
    fusion: str          # gtm | m4ft | gated_v1 | gated_v2 | targ_v3 | tg_v4
    decoder: str         # standard | gated_v1 | gated_v2
    trend_encoder_gated: bool = False


VARIANTS = {
    # Each pins the JAX package's configuration of that reference model.
    "gtm": Seq2SeqVariant("gtm", "gtm", "standard"),
    "m4ft": Seq2SeqVariant("m4ft", "m4ft", "standard"),
    "gated_v1": Seq2SeqVariant("gtm", "gated_v1", "gated_v1"),
    "gated_v2": Seq2SeqVariant("gtm", "gated_v2", "gated_v2", trend_encoder_gated=True),
    "gated_v3": Seq2SeqVariant("m4ft", "targ_v3", "standard"),
    "gated_v4": Seq2SeqVariant("gtm", "tg_v4", "standard"),
}
# Fusions whose call takes (temporal, text, image); the rest take
# (image, text, temporal), as in the JAX package.
_TEMPORAL_FIRST = ("m4ft", "targ_v3")


class Seq2SeqForecaster(nn.Module):
    def __init__(self, variant: str = "gtm", embedding_dim: int = 32,
                 hidden_dim: int = 64, output_len: int = 12, num_heads: int = 4,
                 num_layers: int = 1, vocab: VocabSizes = VocabSizes(5, 6, 5),
                 trend_len: int = 52, num_trends: int = 3,
                 use_encoder_mask: bool = True, autoregressive: bool = False,
                 use_text: bool = True, use_img: bool = True,
                 query_modality: str = "text",
                 image_arch: str = "resnet101", image_dtype=torch.float32):
        super().__init__()
        if variant not in VARIANTS:
            raise KeyError(f"unknown variant {variant!r}; known: {sorted(VARIANTS)}")
        cfg = VARIANTS[variant]
        if cfg.fusion == "tg_v4" and not use_text:
            raise ValueError("TG-Fusion is text-anchored: use_text=False is "
                             "structurally impossible for gated_v4")
        E, H = embedding_dim, hidden_dim
        self.variant = variant
        self.fusion_kind = cfg.fusion
        self.output_len = output_len
        self.autoregressive = autoregressive

        self.gtrend_encoder = GTrendEmbedder(
            output_len, H, num_trends=num_trends, trend_len=trend_len,
            use_mask=use_encoder_mask, num_layers=2,
            nhead=num_heads if cfg.trend_encoder_gated else 4,
            gated=cfg.trend_encoder_gated)
        # The m4ft style projects every modality to hidden_dim.
        m4ft = cfg.encoder_style == "m4ft"
        self.text_encoder = (AttributeEncoder(
            vocab.num_cat, vocab.num_col, vocab.num_fab, vocab.num_store, E,
            combine="concat_proj" if m4ft else "stack", hidden_dim=H)
            if use_text else None)
        self.image_encoder = (ImagePooledEncoder(E, final_dim=H if m4ft else None,
                                                 arch=image_arch, dtype=image_dtype)
                              if use_img else None)
        self.temporal_encoder = TemporalEmbedder(E, H) if m4ft else None
        self.dummy_encoder = None if m4ft else DummyEmbedder(E)
        ablations = dict(use_img=use_img, use_text=use_text)
        self.fusion = {
            "gtm": lambda: GTMFusionNetwork(E, H, **ablations),
            "m4ft": lambda: M4FTFusionNetwork(H),
            "gated_v1": lambda: ResidualGatedFusionNetwork(E, H, **ablations),
            "gated_v2": lambda: PureGatedFusionNetwork(E, H, **ablations),
            "targ_v3": lambda: TARGFusionNetwork(H, query_modality, **ablations),
            "tg_v4": lambda: TextGuidedFusionNetwork(E, H, use_img=use_img),
        }[cfg.fusion]()
        self.sales_encoder = SalesEncoder(H)
        self.decoder = TransformerDecoder(H, num_heads, num_layers,
                                          dim_feedforward=H * 4, variant=cfg.decoder)
        if autoregressive:
            self.pos_encoder = PositionalEncoding(H, max_len=max(output_len, 12))
            self.decoder_fc = nn.Linear(H, 1)
        else:
            self.decoder_fc = nn.Linear(H, output_len)

    def forward(self, batch):
        if self.training:
            raise NotImplementedError(
                "the port runs eval forwards only; training arrives with the "
                "training slice, ROADMAP Queue 1 item 8 (call .eval())")
        item_sales = batch.get("X")
        if item_sales is None:
            # Demand batches carry no history: zeros(bs, 1, 2).
            ts = batch["ts"]
            item_sales = ts.new_zeros(ts.shape[0], 1, 2)
        sales, B, W = flatten_windows(item_sales)
        N = B * W

        memory = repeat_windows(self.gtrend_encoder(batch["gtrends"]), W)
        h_text = h_img = None
        if self.text_encoder is not None:
            h_text = repeat_windows(self.text_encoder(
                batch["cat"], batch["col"], batch["fab"], batch["store"]), W)
        if self.image_encoder is not None:
            h_img = repeat_windows(self.image_encoder(
                batch["images"], img_idx=batch.get("img_idx")), W)
        temporal_encoder = (self.dummy_encoder if self.temporal_encoder is None
                            else self.temporal_encoder)
        h_dummy = repeat_windows(temporal_encoder(batch["temporal"]), W)
        if self.fusion_kind in _TEMPORAL_FIRST:
            static_context = self.fusion(h_dummy, h_text, h_img)
        else:
            static_context = self.fusion(h_img, h_text, h_dummy)

        h_sales = self.sales_encoder(sales)
        decoder_input = h_sales[:, -1, :] + static_context

        if self.autoregressive:
            tgt = decoder_input.new_zeros(N, self.output_len, decoder_input.shape[-1])
            tgt[:, 0, :] = decoder_input
            tgt = self.pos_encoder(tgt)
            mask = causal_mask(self.output_len, device=tgt.device)
            out = self.decoder(tgt, memory, tgt_mask=mask)
            forecast = self.decoder_fc(out)[..., 0]
        else:
            out = self.decoder(decoder_input[:, None, :], memory)
            forecast = self.decoder_fc(out[:, 0, :])
        return forecast.reshape(N, self.output_len), None
