"""Head layout helpers shared by the attention modules and the kernel
wrappers: ``[B, L, h·d]`` <-> ``[B, h, L, d]``."""

from __future__ import annotations


def split_heads(x, num_heads):
    B, L, D = x.shape
    return x.reshape(B, L, num_heads, D // num_heads).transpose(1, 2)


def merge_heads(x):
    B, h, L, d = x.shape
    return x.transpose(1, 2).reshape(B, L, h * d)
