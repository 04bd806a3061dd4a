"""GTM-family transformer forecaster, counterpart of
``visuelle2_tpu/models/seq2seq.py``.

One configurable ``Seq2SeqForecaster``; the ``VARIANTS`` table pins each
reference model.  This slice ports ``gated_v4`` (TG-Fusion + standard
encoder/decoder), non-AR and AR; the other variants raise
``NotImplementedError`` naming the ROADMAP slice that ports them.

Decode semantics:

* non-AR: a single fused token cross-attends over the 52-step trend memory,
  then ``Linear(H -> out_len)``.
* AR: an ``out_len``-token target (position 0 = fused context, rest zeros)
  with sinusoidal positions and a causal mask, ``Linear(H -> 1)``.

The trend encoder has 4 heads unless it is the gated (v2) one, which takes
``num_heads``.  Eval mode only: training arrives with the training slice.
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
)
from visuelle2_tpu_torch.models.fusion import TextGuidedFusionNetwork
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
    "gtm": Seq2SeqVariant("gtm", "gtm", "standard"),
    "m4ft": Seq2SeqVariant("m4ft", "m4ft", "standard"),
    "gated_v1": Seq2SeqVariant("gtm", "gated_v1", "gated_v1"),
    "gated_v2": Seq2SeqVariant("gtm", "gated_v2", "gated_v2", trend_encoder_gated=True),
    "gated_v3": Seq2SeqVariant("m4ft", "targ_v3", "standard"),
    "gated_v4": Seq2SeqVariant("gtm", "tg_v4", "standard"),
}
PORTED_VARIANTS = ("gated_v4",)


class Seq2SeqForecaster(nn.Module):
    def __init__(self, variant: str = "gtm", embedding_dim: int = 32,
                 hidden_dim: int = 64, output_len: int = 12, num_heads: int = 4,
                 num_layers: int = 1, vocab: VocabSizes = VocabSizes(5, 6, 5),
                 trend_len: int = 52, num_trends: int = 3,
                 use_encoder_mask: bool = True, autoregressive: bool = False,
                 use_text: bool = True, use_img: bool = True,
                 image_arch: str = "resnet101", image_dtype=torch.float32):
        super().__init__()
        if variant not in VARIANTS:
            raise KeyError(f"unknown variant {variant!r}; known: {sorted(VARIANTS)}")
        if variant not in PORTED_VARIANTS:
            raise NotImplementedError(
                f"variant {variant!r} is ported with the seq2seq-family slice, "
                "ROADMAP Queue 1 item 6")
        if not use_text:
            raise ValueError("TG-Fusion is text-anchored: use_text=False is "
                             "structurally impossible for gated_v4")
        cfg = VARIANTS[variant]
        E, H = embedding_dim, hidden_dim
        self.variant = variant
        self.output_len = output_len
        self.autoregressive = autoregressive
        self.use_img = use_img

        self.gtrend_encoder = GTrendEmbedder(
            output_len, H, num_trends=num_trends, trend_len=trend_len,
            use_mask=use_encoder_mask, num_layers=2,
            nhead=num_heads if cfg.trend_encoder_gated else 4,
            gated=cfg.trend_encoder_gated)
        self.text_encoder = AttributeEncoder(
            vocab.num_cat, vocab.num_col, vocab.num_fab, vocab.num_store, E,
            combine="stack")
        self.image_encoder = (ImagePooledEncoder(E, arch=image_arch, dtype=image_dtype)
                              if use_img else None)
        self.dummy_encoder = DummyEmbedder(E)
        self.fusion = TextGuidedFusionNetwork(E, H, use_img=use_img)
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
        h_text = repeat_windows(self.text_encoder(
            batch["cat"], batch["col"], batch["fab"], batch["store"]), W)
        h_img = None
        if self.image_encoder is not None:
            h_img = repeat_windows(self.image_encoder(
                batch["images"], img_idx=batch.get("img_idx")), W)
        h_dummy = repeat_windows(self.dummy_encoder(batch["temporal"]), W)
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
