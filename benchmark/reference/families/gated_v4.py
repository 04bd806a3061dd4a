"""The fork's gated_v4 (``Proposed_model_v4``: GTM encoders, TG-Fusion, a
standard decoder), plain float32, as a function of a parameter dict in the
port's layout, and one row's work outside the backbone."""

from __future__ import annotations

import torch
from torch.nn import functional as F

from benchmark.reference.model import (Params, Runtime, backbone, conv, gcd_block_mask, gru,
                                       layer_norm, linear, low, mha, normalize_images,
                                       sinusoidal_table)
from benchmark.yardstick.flops import NUM_TRENDS, TREND_LEN, gru_flops, linear_flops, mha_flops

ENCODER_FFN = 2048  # the trend encoder's feed-forward width (GTM family)


def _encoder_layer(P, name, x, mask, heads, rate, rt):
    attn = mha(P, f"{name}.self_attn", x, x, x, heads, rate, rt, mask=mask)
    x = layer_norm(P, f"{name}.norm1", x + rt.drop(attn, rate))
    ffn = linear(P, f"{name}.ffn.linear2",
                 rt.drop(torch.relu(linear(P, f"{name}.ffn.linear1", x)), rate))
    return layer_norm(P, f"{name}.norm2", x + rt.drop(ffn, rate))


def _decoder_layer(P, name, tgt, memory, heads, rate, rt):
    sa = mha(P, f"{name}.self_attn", tgt, tgt, tgt, heads, rate, rt)
    tgt = layer_norm(P, f"{name}.norm1", tgt + rt.drop(sa, rate))
    ca = mha(P, f"{name}.cross_attn", tgt, memory, memory, heads, rate, rt)
    tgt = layer_norm(P, f"{name}.norm2", tgt + rt.drop(ca, rate))
    ffn = linear(P, f"{name}.ffn.linear2",
                 rt.drop(torch.relu(linear(P, f"{name}.ffn.linear1", tgt)), rate))
    return layer_norm(P, f"{name}.norm3", tgt + rt.drop(ffn, rate))


def _gated(P, name, x, ctx):
    """TG-Fusion's soft gate: σ([ctx, x]·kernel + b), residual x + x·g; the
    kernel's first rows belong to ctx."""
    kernel, bias = P[f"{name}.kernel"], P[f"{name}.bias"]
    C = ctx.shape[-1]
    g = torch.sigmoid(x @ kernel[C:] + ctx @ kernel[:C] + bias)
    return x + x * g


def forward(P: Params, batch: dict, m: dict, rt: Runtime) -> torch.Tensor:
    """-> forecast [B, output_len]."""
    H, heads, out_len = m["hidden_dim"], m["num_heads"], m["output_len"]
    ts = batch["ts"]
    B = ts.shape[0]
    # Trend encoder: linear, positions, two post-norm layers (4 heads, FFN
    # 2048, dropout 0.2) under the gcd block mask.
    x = linear(P, "gtrend_encoder.input_linear", batch["gtrends"].transpose(1, 2))
    x = rt.drop(x + sinusoidal_table(x.shape[1], H, x.device)[None], 0.1)
    mask = gcd_block_mask(x.shape[1], out_len, x.device)
    for i in range(2):
        x = _encoder_layer(P, f"gtrend_encoder.encoder.layer{i}", x, mask, 4, 0.2, rt)
    memory = x
    # Attributes, stacked.
    text = torch.stack([F.embedding(batch[k], P[f"text_encoder.{k}.weight"])
                        for k in ("cat", "col", "fab", "store")], dim=1)
    text = rt.drop(text, 0.1)
    # Image: backbone, 1x1 projection, global mean.
    feats = backbone(P, "image_encoder.backbone", normalize_images(batch["images"]),
                     m["image_arch"], rt)
    # The projection runs in the backbone's working dtype in the model.
    proj = conv(feats, P["image_encoder.projection.weight"], 1, 0, rt,
                bias=P["image_encoder.projection.bias"])
    img = low(proj.mean(dim=(2, 3)), rt)
    # Temporal (GTM style): four scalar linears, concatenated, fused.
    temporal = batch["temporal"]
    parts = [linear(P, f"dummy_encoder.{k}", temporal[:, i: i + 1])
             for i, k in enumerate(("day", "week", "month", "year"))]
    dummy = rt.drop(linear(P, "dummy_encoder.fusion", torch.cat(parts, dim=-1)), 0.2)
    # TG-Fusion.
    text_flat = text.reshape(B, -1)
    fused = torch.cat([_gated(P, "fusion.img_gate_fc", img, text_flat), text_flat,
                       _gated(P, "fusion.dummy_gate_fc", dummy, text_flat)], dim=-1)
    fused = linear(P, "fusion.fusion_fc", fused)
    static = rt.drop(torch.relu(layer_norm(P, "fusion.fusion_norm", fused)), 0.1)
    # Sales GRU over the Demand batch's zero history [B, 2, 1].
    sales, _ = gru(P, "sales_encoder.gru", ts.new_zeros(B, 2, 1))
    sales = rt.drop(sales, 0.1)
    tgt = (sales[:, -1, :] + static)[:, None, :]
    for i in range(m.get("num_layers", 1)):
        tgt = _decoder_layer(P, f"decoder.layer{i}", tgt, memory, heads, 0.1, rt)
    forecast = linear(P, "decoder_fc", tgt[:, 0, :])
    return rt.drop(forecast, 0.2)


def heads_flops(m: dict) -> int:
    """One row outside the backbone: the 1x1 projection at 10 x 10, the
    trend encoder (2 layers over 52 steps), the temporal and TG-fusion
    linears, the sales GRU over its two zero steps and the decoder's layers
    (one fused token against the 52-step memory)."""
    E, H, out_len = m["embedding_dim"], m["hidden_dim"], m["output_len"]
    proj = 2 * 100 * 2048 * E
    trend = linear_flops(TREND_LEN, NUM_TRENDS, H) + 2 * (
        mha_flops(TREND_LEN, TREND_LEN, H) + 2 * linear_flops(TREND_LEN, H, ENCODER_FFN))
    temporal = 4 * linear_flops(1, 1, E) + linear_flops(1, 4 * E, E)
    C = 4 * E
    fusion = 2 * linear_flops(1, C + E, E) + linear_flops(1, C + 2 * E, H)
    sales = gru_flops(2, 1, H)
    decoder = m.get("num_layers", 1) * (mha_flops(1, 1, H) + mha_flops(1, TREND_LEN, H)
                                        + 2 * linear_flops(1, H, 4 * H))
    return proj + trend + temporal + fusion + sales + decoder + linear_flops(1, H, out_len)
