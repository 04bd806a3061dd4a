"""CrossAttnRNN family, counterpart of ``visuelle2_tpu/models/cross_attn_rnn.py``:
SO-fore 2-1 (``CrossAttnRNN21``), SO-fore 2-10 (``CrossAttnRNN210``) and the
new-product Demand model (``CrossAttnRNNDemand``).

Every decode step runs three additive attentions conditioned on the hidden
state — over the image patches, the trend steps and the fused tokens — each
through the CUDA kernel ``fused_additive_attention`` on the card
(``ops/attention.py::AdditiveAttention``).  The JAX ``nn.scan`` over the
decode cell becomes a Python loop over ``out_len`` steps of one ``decoder``
child module, whose parameters every step shares, as
``variable_broadcast="params"`` shares them; the static encodings are
computed once.

Train mode follows the JAX modules: dropout at their rates (the trend
self-attention's probabilities at 0.1), masks drawn from the ``generator``
handed to ``forward`` (``ops/dropout.py``), BatchNorm batch statistics in the
backbone, and teacher forcing (scheduled sampling) in 2-10 and Demand when
``use_teacher_forcing`` is set: one coin per decode step, shared by the
batch, all ``out_len`` drawn as ``rand(out_len) < teacher_forcing_ratio``
from that generator before any dropout mask (the JAX ``sampling`` rng), and
step t's next input is ``where(coin_t, teacher_t, prediction)`` on the
device, so a step never waits on the host.  In eval mode no coin fires and
each step's input is the previous step's prediction.
"""

from __future__ import annotations

import torch
from torch import nn

from visuelle2_tpu_torch.models.base import VocabSizes, flatten_windows, repeat_windows
from visuelle2_tpu_torch.models.encoders import (
    AttributeEncoder,
    ImagePatchEncoder,
    TemporalFeatureEncoder,
    TSEmbedder,
)
from visuelle2_tpu_torch.ops import dropout
from visuelle2_tpu_torch.ops.attention import AdditiveAttention, MultiHeadAttention
from visuelle2_tpu_torch.ops.gru import GRU, GRUCellModule

TREND_LEN = 52  # weeks of Google-trend history per product
TREND_ATTENTION_DROPOUT = 0.1  # the trend self-attention's probabilities


def teacher_coins(out_len: int, ratio: float, device, generator=None) -> torch.Tensor:
    """The decode's scheduled-sampling coins: [out_len] bool on ``device``,
    one a step shared by the batch, true with probability ``ratio``."""
    return torch.rand(out_len, device=device, generator=generator) < ratio


class _StaticEncodings(nn.Module):
    """The modality encodings every variant computes once per forward:
    (image patches [B, P, E] or None, trend steps [B, 52, E], temporal [B, E],
    attributes [B, E])."""

    def __init__(self, embedding_dim: int, vocab: VocabSizes, num_trends: int = 3,
                 use_img: bool = True, image_arch: str = "resnet101",
                 image_dtype=torch.float32, image_remat: bool = False,
                 faithful_temporal_bug: bool = False):
        super().__init__()
        E = embedding_dim
        self.image_encoder = (ImagePatchEncoder(E, arch=image_arch, dtype=image_dtype,
                                                remat=image_remat)
                              if use_img else None)
        self.trend_encoder = TSEmbedder(E, input_dim=num_trends)
        self.temp_encoder = TemporalFeatureEncoder(
            E, shared_day_embedding=faithful_temporal_bug)
        self.attribute_encoder = AttributeEncoder(
            vocab.num_cat, vocab.num_col, vocab.num_fab, vocab.num_store, E, combine="sum")

    def forward(self, batch):
        img = None
        if self.image_encoder is not None:
            img = self.image_encoder(batch["images"], img_idx=batch.get("img_idx"))
        trend = self.trend_encoder(batch["gtrends"].transpose(1, 2))
        temporal = self.temp_encoder(batch["temporal"])
        attributes = self.attribute_encoder(batch["cat"], batch["col"], batch["fab"],
                                            batch["store"])
        return img, trend, temporal, attributes


class _FusionAttention(nn.Module):
    """One step's attentions and fusion: the image patches and the trend
    steps attended under ``hidden``, stacked with the temporal and attribute
    tokens, attended again, added back and embedded -> (context [N, E],
    {"img", "trend", "multimodal"} α)."""

    def __init__(self, embedding_dim: int, attention_dim: int, hidden_dim: int,
                 weight_on: str = "inputs", use_img: bool = True, use_att: bool = True,
                 use_trends: bool = True):
        super().__init__()
        E, A = embedding_dim, attention_dim
        if weight_on == "projected" and A != E:
            # The residual mm_in + attended_mm adds [N, n, E] to [N, n, A].
            raise ValueError(f"weight_on='projected' needs attention_dim == embedding_dim, "
                             f"got {A} and {E}")
        self.use_att = use_att
        Dw = E if weight_on == "inputs" else A
        attention = lambda: AdditiveAttention(E, hidden_dim, A, weight_on=weight_on)
        self.img_attention = attention() if use_img else None
        self.ts_attention = attention() if use_trends else None
        self.trend_linear = nn.Linear(TREND_LEN * Dw, E) if use_trends else None
        self.multimodal_attention = attention()
        self.multimodal_embedder = nn.Linear(E, E)

    def forward(self, img, trend, temporal, attributes, hidden):
        alphas = {}
        tokens = [temporal]
        if self.img_attention is not None:
            attended_img, alphas["img"] = self.img_attention(img, hidden)
            tokens.append(attended_img.sum(dim=1))
        if self.use_att:
            tokens.append(attributes)
        if self.ts_attention is not None:
            attended_trend, alphas["trend"] = self.ts_attention(trend, hidden)
            tokens.append(self.trend_linear(attended_trend.reshape(attended_trend.shape[0], -1)))
        mm_in = torch.stack(tokens, dim=1)
        attended_mm, alphas["multimodal"] = self.multimodal_attention(mm_in, hidden)
        return self.multimodal_embedder((mm_in + attended_mm).sum(dim=1)), alphas


class _DecodeCell(nn.Module):
    """One autoregressive step: fusion under ``hidden``, a GRU step on
    [context, previous prediction], a linear head -> (hidden, pred [N, 1], α)."""

    def __init__(self, embedding_dim: int, attention_dim: int, hidden_dim: int,
                 weight_on: str = "inputs", use_img: bool = True, use_att: bool = True,
                 use_trends: bool = True):
        super().__init__()
        self.fusion = _FusionAttention(embedding_dim, attention_dim, hidden_dim,
                                       weight_on=weight_on, use_img=use_img,
                                       use_att=use_att, use_trends=use_trends)
        self.decoder_cell = GRUCellModule(embedding_dim + 1, hidden_dim)
        self.decoder_fc = nn.Linear(hidden_dim, 1)

    def forward(self, hidden, dec_in, statics):
        context, alphas = self.fusion(*statics, hidden)
        hidden = self.decoder_cell(torch.cat([context, dec_in], dim=-1), hidden)
        return hidden, self.decoder_fc(hidden), alphas


def _decode(cell: _DecodeCell, hidden, dec_in, statics, out_len: int, teacher=None):
    """``out_len`` steps -> (preds [N, T], per-step α dicts).  Each step is
    fed the previous prediction, or with ``teacher = (inputs [N, T], coins
    [T] bool)`` ``inputs[:, t]`` after a step whose coin is true."""
    preds, alphas = [], []
    for t in range(out_len):
        hidden, pred, step_alphas = cell(hidden, dec_in, statics)
        preds.append(pred[:, 0])
        alphas.append(step_alphas)
        if teacher is None:
            dec_in = pred
        else:
            inputs, coins = teacher
            dec_in = torch.where(coins[t], inputs[:, t, None], pred)
    return torch.stack(preds, dim=1), alphas


class _WindowModel(nn.Module):
    """What the SO-fore models share: static encodings repeated per window,
    trend self-attention, and the sales-history GRU over each window."""

    def __init__(self, embedding_dim: int, hidden_dim: int, vocab: VocabSizes,
                 num_trends: int, use_img: bool, image_arch: str, image_dtype,
                 image_remat: bool):
        super().__init__()
        self.static = _StaticEncodings(embedding_dim, vocab, num_trends, use_img,
                                       image_arch=image_arch, image_dtype=image_dtype,
                                       image_remat=image_remat)
        self.ts_self_attention = MultiHeadAttention(embedding_dim, 4,
                                                    dropout=TREND_ATTENTION_DROPOUT)
        self.sales_encoder_gru = GRU(1, hidden_dim)

    def _encode(self, batch):
        """-> (X [N, T, 1], B, W, statics repeated per window, hidden [N, H])."""
        X, B, W = flatten_windows(batch["X"])
        img, trend, temporal, attributes = self.static(batch)
        statics = [None if img is None else repeat_windows(img, W)]
        statics += [repeat_windows(t, W) for t in (trend, temporal, attributes)]
        statics[1], _ = self.ts_self_attention(statics[1], statics[1], statics[1])
        _, hidden = self.sales_encoder_gru(X)
        return X, B, W, statics, hidden


class CrossAttnRNN21(_WindowModel):
    """SO-fore 2-1: all-modality encode, one fusion step under the sales
    GRU's state, linear head -> (pred [B, W, 1], None).  ``out_len`` is
    accepted and, as by the JAX module, not read: the model predicts one step
    and takes no teacher forcing."""

    def __init__(self, attention_dim: int = 512, embedding_dim: int = 512,
                 hidden_dim: int = 512, vocab: VocabSizes = VocabSizes(5, 6, 5),
                 num_trends: int = 3, use_img: bool = True, out_len: int = 1,
                 image_arch: str = "resnet101", image_dtype=torch.float32,
                 image_remat: bool = False):
        super().__init__(embedding_dim, hidden_dim, vocab, num_trends, use_img, image_arch,
                         image_dtype, image_remat)
        self.fusion = _FusionAttention(embedding_dim, attention_dim, hidden_dim,
                                       use_img=use_img)
        self.decoder_fc = nn.Linear(embedding_dim, 1)

    def forward(self, batch, *, generator=None):
        """-> (pred [B, W, 1], None); in train mode the dropout masks are
        drawn from ``generator`` (torch's default one if None)."""
        with dropout.use_generator(generator):
            _, B, W, statics, hidden = self._encode(batch)
            context, _ = self.fusion(*statics, hidden)
            return self.decoder_fc(context).reshape(B, W, 1), None


class CrossAttnRNN210(_WindowModel):
    """SO-fore 2-10: an ``out_len``-step decode from the sales GRU's state and
    the last observed sale -> (preds [B·W, out_len], None).  Teacher forcing
    (train mode, ``use_teacher_forcing``, a batch with ``y``) feeds the
    target ``y`` [B, W, out_len]."""

    def __init__(self, attention_dim: int = 512, embedding_dim: int = 512,
                 hidden_dim: int = 512, vocab: VocabSizes = VocabSizes(5, 6, 5),
                 num_trends: int = 3, use_img: bool = True, out_len: int = 10,
                 use_teacher_forcing: bool = True, teacher_forcing_ratio: float = 0.5,
                 image_arch: str = "resnet101", image_dtype=torch.float32,
                 image_remat: bool = False):
        super().__init__(embedding_dim, hidden_dim, vocab, num_trends, use_img, image_arch,
                         image_dtype, image_remat)
        self.out_len = out_len
        self.use_teacher_forcing = use_teacher_forcing
        self.teacher_forcing_ratio = teacher_forcing_ratio
        self.decoder = _DecodeCell(embedding_dim, attention_dim, hidden_dim, use_img=use_img)

    def forward(self, batch, *, generator=None):
        """-> (preds [B·W, out_len], None); in train mode the coins and the
        dropout masks are drawn from ``generator`` (torch's default one if
        None)."""
        teacher = None
        if self.use_teacher_forcing and self.training and "y" in batch:
            y = batch["y"]
            teacher = (y.reshape(-1, self.out_len),
                       teacher_coins(self.out_len, self.teacher_forcing_ratio, y.device,
                                     generator))
        with dropout.use_generator(generator):
            X, _, _, statics, hidden = self._encode(batch)
            preds, _ = _decode(self.decoder, hidden, X[:, -1, :], statics, self.out_len,
                               teacher)
        return preds, None


class CrossAttnRNNDemand(nn.Module):
    """Demand (new product): an ``out_len``-step decode from zero state and
    zero input, attention on the projected encodings, with the
    ``use_img``/``use_att``/``use_trends`` ablations -> (forecast [N, T, 1],
    α {"img", "trend", "multimodal"}, each [T, N, L]).  Teacher forcing
    (train mode, ``use_teacher_forcing``) feeds the series ``ts`` itself."""

    def __init__(self, attention_dim: int = 512, embedding_dim: int = 512,
                 hidden_dim: int = 512, vocab: VocabSizes = VocabSizes(5, 6, 5),
                 num_trends: int = 3, use_img: bool = True, use_att: bool = True,
                 use_trends: bool = True, out_len: int = 12,
                 use_teacher_forcing: bool = False, teacher_forcing_ratio: float = 0.5,
                 image_arch: str = "resnet101", image_dtype=torch.float32,
                 image_remat: bool = False, faithful_temporal_bug: bool = False):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.out_len = out_len
        self.use_teacher_forcing = use_teacher_forcing
        self.teacher_forcing_ratio = teacher_forcing_ratio
        self.static = _StaticEncodings(embedding_dim, vocab, num_trends, use_img,
                                       image_arch=image_arch, image_dtype=image_dtype,
                                       image_remat=image_remat,
                                       faithful_temporal_bug=faithful_temporal_bug)
        self.ts_self_attention = (
            MultiHeadAttention(embedding_dim, 4, dropout=TREND_ATTENTION_DROPOUT)
            if use_trends else None)
        self.decoder = _DecodeCell(embedding_dim, attention_dim, hidden_dim,
                                   weight_on="projected", use_img=use_img,
                                   use_att=use_att, use_trends=use_trends)

    def forward(self, batch, *, generator=None):
        """-> (forecast, α); in train mode the coins and the dropout masks are
        drawn from ``generator`` (torch's default one if None)."""
        ts = batch["ts"]
        N = ts.shape[0]
        teacher = None
        if self.use_teacher_forcing and self.training:
            teacher = (ts, teacher_coins(self.out_len, self.teacher_forcing_ratio, ts.device,
                                         generator))
        with dropout.use_generator(generator):
            img, trend, temporal, attributes = self.static(batch)
            if self.ts_self_attention is not None:
                trend, _ = self.ts_self_attention(trend, trend, trend)
            hidden = ts.new_zeros(N, self.hidden_dim)
            dec_in = ts.new_zeros(N, 1)
            preds, alphas = _decode(self.decoder, hidden, dec_in,
                                    (img, trend, temporal, attributes), self.out_len,
                                    teacher)
        stacked = {k: torch.stack([a[k] for a in alphas]) for k in alphas[0]}
        return preds[..., None], stacked
