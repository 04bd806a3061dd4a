"""GTM — the original VISUELLE-1 Google-Trends transformer, counterpart of
``visuelle2_tpu/models/gtm_v1.py`` (the reference's ``models/GTM.py``).

* **Text branch**: the frozen text featurizer runs once at ingest, on the
  host (``TextFeaturizer``: "color fabric category" strings to [N, 768]
  float32); in the forward only ``Linear(768 -> E)`` and dropout 0.1.  The
  port has no BERT: its featurizer is the JAX package's deterministic
  crc32-seeded fallback, fingerprint ``hashed-crc32-v1``, bit for bit.
* **Image branch**: a fully frozen ResNet-50 feature map
  (``_FrozenImageTower``): its BatchNorm always on running statistics, even
  when the model trains, and no gradient through it; the map is cast to
  float32.
* **Fusion** (``GTMv1FusionNetwork``): the map pooled over H and W,
  ``Linear(2048, E)``, concatenated with the text and temporal encodings by
  ``use_img`` / ``use_text``, then BatchNorm1d (batch statistics in
  training), ``Linear`` with no bias, ReLU, dropout 0.2, ``Linear(H)``.
* **Decoder**: ``MemoryOnlyDecoderLayer`` — cross-attention and FFN only,
  post-norm with ``norm2`` / ``norm3``, returning the head-averaged
  attention weights.  Non-AR: the fused token, ``Linear(H -> out_len)``.
  AR: ``out_len`` tokens (the fused context first, zeros after) with
  sinusoidal positions (``max_len = max(out_len, 12)``), ``Linear(H -> 1)``.
  The reference computes a causal mask for the AR decode and hands it to a
  layer that has no self-attention and ignores it; the JAX module adds it
  to the cross-attention scores, whose shape [.., 12, 52] it does not fit,
  so its AR forward raises.  The port's AR decode takes no mask, as the
  reference's.
* The last dropout, 0.2, acts on the forecast itself.  The norm scalar for
  metrics is 1065 (VISUELLE-1's train max), not 53.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch
from torch import nn

from visuelle2_tpu_torch.data.images import normalize_images
from visuelle2_tpu_torch.models.encoders import DummyEmbedder, GTrendEmbedder
from visuelle2_tpu_torch.models.norms import BatchNorm1d
from visuelle2_tpu_torch.models.resnet import STAGE_BLOCKS, ResNetBackbone
from visuelle2_tpu_torch.ops import dropout
from visuelle2_tpu_torch.ops.attention import MultiHeadAttention
from visuelle2_tpu_torch.ops.dropout import Dropout
from visuelle2_tpu_torch.ops.positional import PositionalEncoding
from visuelle2_tpu_torch.ops.transformer import LN_EPS
from visuelle2_tpu_torch.parallel import collectives

GTM_V1_NORM_SCALAR = 1065.0  # GTM.py:321

BERT_DIM = 768
HASHED_FINGERPRINT = "hashed-crc32-v1"


class TextFeaturizer:
    """Host-side text featurizer, run once at ingest: each item's
    "color fabric category" string to a [768] float32 vector, the mean over
    its words of a standard normal vector seeded by the word's crc32 (the JAX
    package's fallback when no BERT is available; a stable digest, never
    Python's salted ``hash``).  ``fingerprint`` goes into ``hparams.json``
    and is checked when a checkpoint is scored."""

    fingerprint = HASHED_FINGERPRINT

    def __init__(self, cat_dict, col_dict, fab_dict):
        self.inv_cat = {v: k for k, v in cat_dict.items()}
        self.inv_col = {v: k for k, v in col_dict.items()}
        self.inv_fab = {v: k for k, v in fab_dict.items()}
        print("[gtm_v1] BERT unavailable (the port has no BERT featurizer); "
              "using deterministic hashed text features")

    @staticmethod
    def _hashed(text: str) -> np.ndarray:
        vec = np.zeros(BERT_DIM, np.float32)
        for tok in text.split():
            rng = np.random.default_rng(zlib.crc32(tok.encode("utf-8")))
            vec += rng.standard_normal(BERT_DIM).astype(np.float32)
        return vec / max(1, len(text.split()))

    def __call__(self, category, color, fabric) -> np.ndarray:
        texts = [f"{self.inv_col[int(c)]} {self.inv_fab[int(f)]} {self.inv_cat[int(k)]}"
                 for k, c, f in zip(category, color, fabric)]
        return np.stack([self._hashed(t) for t in texts])


class _FrozenImageTower(nn.Module):
    """The fully frozen CNN feature map: uint8 NHWC -> float32 [B, 2048, h, w]
    (an NCHW view of channels_last memory).  The CNN child is ``backbone``,
    like every image encoder's, so the freeze rule and the pretrained splice
    reach it.  Its BatchNorm stays on running statistics whatever the
    model's mode (``train`` keeps the backbone in eval mode), and its
    parameters take no gradient."""

    def __init__(self, arch: str = "resnet50", dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.backbone = ResNetBackbone(STAGE_BLOCKS[arch], dtype=dtype)
        self.backbone.requires_grad_(False)

    def train(self, mode: bool = True):
        super().train(mode)
        self.backbone.eval()
        return self

    def forward(self, images_u8):
        x = normalize_images(images_u8, dtype=self.dtype).permute(0, 3, 1, 2)
        with torch.no_grad():
            return self.backbone(x).float()


class MemoryOnlyDecoderLayer(nn.Module):
    """Cross-attention + FFN, post-norm; returns ``(tgt, weights)`` with the
    attention probabilities averaged over heads.  No self-attention."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int, dropout: float = 0.1):
        super().__init__()
        self.multihead_attn = MultiHeadAttention(d_model, nhead, dropout)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm3 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.drop_attn, self.drop_hidden, self.drop_ffn = (Dropout(dropout) for _ in range(3))

    def forward(self, tgt, memory):
        attn, weights = self.multihead_attn(tgt, memory, memory)
        tgt = self.norm2(tgt + self.drop_attn(attn))
        h = self.drop_hidden(torch.relu(self.linear1(tgt)))
        tgt = self.norm3(tgt + self.drop_ffn(self.linear2(h)))
        return tgt, weights


class GTMv1FusionNetwork(nn.Module):
    """The reference's ``FusionNetwork`` (``GTM.py:54-88``)."""

    def __init__(self, embedding_dim: int, hidden_dim: int, use_img: bool = True,
                 use_text: bool = True, dropout: float = 0.2):
        super().__init__()
        E = embedding_dim
        D = E * (1 + int(use_img) + int(use_text))
        self.use_text = use_text
        self.img_linear = nn.Linear(2048, E) if use_img else None
        self.bn = BatchNorm1d(D)
        self.fc1 = nn.Linear(D, D, bias=False)
        self.drop = Dropout(dropout)
        self.fc2 = nn.Linear(D, hidden_dim)

    def forward(self, img_feature_map, text_encoding, dummy_encoding):
        parts = []
        if self.img_linear is not None:
            parts.append(self.img_linear(img_feature_map.mean(dim=(2, 3))))
        if self.use_text:
            parts.append(text_encoding)
        parts.append(dummy_encoding)
        x = self.bn(torch.cat(parts, dim=-1))
        return self.fc2(self.drop(torch.relu(self.fc1(x))))


class GTMv1(nn.Module):
    """The original GTM.  Batch: the demand dict plus ``text_features
    [B, 768]`` from ``TextFeaturizer``; returns ``(forecast [B, out_len],
    the last decoder layer's attention weights [B, Lq, trend_len])``."""

    def __init__(self, embedding_dim: int = 32, hidden_dim: int = 64, output_len: int = 12,
                 num_heads: int = 4, num_layers: int = 1, use_text: bool = True,
                 use_img: bool = True, trend_len: int = 52, num_trends: int = 3,
                 use_encoder_mask: bool = True, autoregressive: bool = False,
                 image_arch: str = "resnet50", image_dtype=torch.float32,
                 image_remat: bool = False):
        super().__init__()
        # image_remat is accepted for build()'s uniform surface and unused:
        # the tower has no backward to rematerialize.
        E, H = embedding_dim, hidden_dim
        self.output_len = output_len
        self.autoregressive = autoregressive
        self.use_img = use_img
        self.num_layers = num_layers
        self.image_encoder = _FrozenImageTower(image_arch, dtype=image_dtype)
        self.dummy_encoder = DummyEmbedder(E)
        self.text_fc = nn.Linear(BERT_DIM, E)
        self.text_drop = Dropout(0.1)
        self.gtrend_encoder = GTrendEmbedder(output_len, H, num_trends=num_trends,
                                             trend_len=trend_len, use_mask=use_encoder_mask,
                                             num_layers=2, nhead=4)
        self.static_feature_encoder = GTMv1FusionNetwork(E, H, use_img=use_img,
                                                         use_text=use_text)
        for i in range(num_layers):
            self.add_module(f"decoder{i}", MemoryOnlyDecoderLayer(H, num_heads, H * 4))
        if autoregressive:
            self.pos_encoder = PositionalEncoding(H, max_len=max(output_len, 12))
            self.decoder_fc = nn.Linear(H, 1)
        else:
            self.decoder_fc = nn.Linear(H, output_len)
        self.forecast_drop = Dropout(0.2)

    def forward(self, batch, *, generator=None):
        """In train mode the dropout masks are drawn from ``generator``
        (torch's default one if None)."""
        with dropout.use_generator(generator):
            return self._forward(batch)

    def _forward(self, batch):
        feats = None
        if self.use_img:
            # The JAX module builds the tower either way; XLA drops its
            # unused output when use_img is off.
            feats = self.image_encoder(batch["images"])
            if batch.get("img_idx") is not None:
                # A unique-image batch (eval dedup): expand to rows.
                feats = collectives.select_global_rows(feats, batch["img_idx"])
        dummy = self.dummy_encoder(batch["temporal"])
        text = self.text_drop(self.text_fc(batch["text_features"]))
        memory = self.gtrend_encoder(batch["gtrends"])
        context = self.static_feature_encoder(feats, text, dummy)

        if self.autoregressive:
            tgt = context.new_zeros(context.shape[0], self.output_len, context.shape[-1])
            tgt[:, 0, :] = context
            out, attn = self._decode(self.pos_encoder(tgt), memory)
            forecast = self.decoder_fc(out)[..., 0]
        else:
            out, attn = self._decode(context[:, None, :], memory)
            forecast = self.decoder_fc(out[:, 0, :])
        forecast = self.forecast_drop(forecast)
        return forecast.reshape(-1, self.output_len), attn

    def _decode(self, tgt, memory):
        weights = None
        for i in range(self.num_layers):
            tgt, weights = getattr(self, f"decoder{i}")(tgt, memory)
        return tgt, weights
