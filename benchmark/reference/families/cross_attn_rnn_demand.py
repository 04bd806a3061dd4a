"""VISUELLE 2.0's CrossAttnRNN Demand, plain float32, as a function of a
parameter dict in the port's layout, and one row's work outside the
backbone."""

from __future__ import annotations

import torch
from torch.nn import functional as F

from benchmark.reference.model import Params, Runtime, backbone, gru, gru_cell, linear, mha, \
    normalize_images
from benchmark.yardstick.flops import (NUM_TRENDS, TREND_LEN, additive_attention_flops,
                                       gru_flops, linear_flops, mha_flops)

PATCHES = 100  # ResNet-101's 10 x 10 output at 299 x 299
TOKENS = 4  # the multimodal attention's tokens


def additive_attention(P, name, enc, dec, weight_on: str):
    """Bahdanau attention: α = softmax_L(tanh(enc·We + dec·Wd)·v + vb);
    returns α ⊙ (enc or enc·We)."""
    h = enc @ P[f"{name}.encoder_linear.kernel"]
    s = dec @ P[f"{name}.decoder_linear.kernel"]
    energy = (torch.tanh(h + s[:, None, :]) @ P[f"{name}.attn_linear.kernel"])[..., 0] \
        + P[f"{name}.attn_linear.bias"][0]
    alpha = torch.softmax(energy, dim=1)
    return alpha[..., None] * (enc if weight_on == "inputs" else h)


def forward(P: Params, batch: dict, m: dict, rt: Runtime) -> torch.Tensor:
    """-> forecast [B, out_len]."""
    ts = batch["ts"]
    N, T = ts.shape[0], m["out_len"]
    coins = None
    if rt.train and m.get("use_teacher_forcing", False):
        coins = rt.coins(T, m["teacher_forcing_ratio"], ts.device)
    feats = backbone(P, "static.image_encoder.backbone",
                     normalize_images(batch["images"]), m["image_arch"], rt)
    B, C, h, w = feats.shape
    patches = feats.permute(0, 2, 3, 1).reshape(B, h * w, C)
    img = rt.drop(linear(P, "static.image_encoder.fc", patches), 0.1)
    trend, _ = gru(P, "static.trend_encoder.gru", batch["gtrends"].transpose(1, 2))
    trend = rt.drop(trend, 0.1)
    temporal = 0.0
    for i, k in enumerate(("day", "week", "month", "year")):
        temporal = temporal + rt.drop(
            linear(P, f"static.temp_encoder.{k}", batch["temporal"][:, i: i + 1]), 0.1)
    attributes = 0.0
    for k in ("cat", "col", "fab", "store"):
        attributes = attributes + rt.drop(
            F.embedding(batch[k], P[f"static.attribute_encoder.{k}.weight"]), 0.1)
    trend = mha(P, "ts_self_attention", trend, trend, trend, 4, 0.1, rt)
    hidden = ts.new_zeros(N, m["hidden_dim"])
    dec_in = ts.new_zeros(N, 1)
    preds = []
    f = "decoder.fusion"
    cell = [P[f"decoder.decoder_cell.{k}"] for k in ("w_i", "w_h", "b_i", "b_h")]
    for t in range(T):
        att_img = additive_attention(P, f"{f}.img_attention", img, hidden, "projected")
        att_trend = additive_attention(P, f"{f}.ts_attention", trend, hidden, "projected")
        tokens = [temporal, att_img.sum(dim=1), attributes,
                  linear(P, f"{f}.trend_linear", att_trend.reshape(N, -1))]
        mm_in = torch.stack(tokens, dim=1)
        att_mm = additive_attention(P, f"{f}.multimodal_attention", mm_in, hidden, "projected")
        context = linear(P, f"{f}.multimodal_embedder", (mm_in + att_mm).sum(dim=1))
        hidden = gru_cell(torch.cat([context, dec_in], dim=-1), hidden, *cell)
        pred = linear(P, "decoder.decoder_fc", hidden)
        preds.append(pred[:, 0])
        dec_in = pred if coins is None else torch.where(coins[t], ts[:, t, None], pred)
    return torch.stack(preds, dim=1)


def heads_flops(m: dict) -> int:
    """One row outside the backbone: the patch linear, the trend GRU, the
    temporal linears, the trend self-attention and ``out_len`` decode steps
    (three additive attentions, the trend linear, the multimodal embedder, a
    GRU cell, the head)."""
    E, A, H, out_len = m["embedding_dim"], m["attention_dim"], m["hidden_dim"], m["out_len"]
    img = linear_flops(PATCHES, 2048, E)
    trend = gru_flops(TREND_LEN, NUM_TRENDS, E)
    temporal = 4 * linear_flops(1, 1, E)
    self_att = mha_flops(TREND_LEN, TREND_LEN, E)
    step = (additive_attention_flops(PATCHES, E, H, A, "projected")
            + additive_attention_flops(TREND_LEN, E, H, A, "projected")
            + additive_attention_flops(TOKENS, E, H, A, "projected")
            + linear_flops(1, TREND_LEN * A, E) + linear_flops(1, E, E)
            + gru_flops(1, E + 1, H) + linear_flops(1, H, 1))
    return img + trend + temporal + self_att + out_len * step
