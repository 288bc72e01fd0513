"""Set-transformer baseline over all graph nodes (port of
`geometry_rl_tpu/models/transformer.py`).

Tokens are the concatenated flat node features of every node type; a post-norm
multi-head encoder with ReLU feed-forward blocks of width `hidden_dim`;
readout at the output node slice, optionally concatenated with a CLS global
token. Padded nodes are masked out of attention as keys.
`forward(graph, feats) -> (out [B, G, output_dim], h [B, G, hidden_dim or 2x])`.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..graphs.homogenize import concat_features, homogenize
from ..graphs.types import GraphFeatures, HeteroGraph
from .common import Dense, LayerNorm


class MultiHeadDotProductAttention(nn.Module):
    """Flax's `nn.MultiHeadDotProductAttention` for self-attention: the query
    is scaled by 1/sqrt(head_dim) before the product, masked logits are set to
    the dtype's most negative value, and the softmax runs in `dtype`. The
    projections hold Flax's `[in, heads, head_dim]` kernels flattened to
    `[heads * head_dim, in]` weights (`convert.params_from_flax`)."""

    def __init__(self, hidden_dim: int, num_heads: int, dtype=torch.float32, device=None):
        super().__init__()
        if hidden_dim % num_heads:
            raise ValueError(f"hidden_dim {hidden_dim} is not divisible by num_heads {num_heads}")
        self.num_heads, self.head_dim, self.dtype = num_heads, hidden_dim // num_heads, dtype
        kw = dict(dtype=dtype, device=device)
        self.query = Dense(hidden_dim, hidden_dim, **kw)
        self.key = Dense(hidden_dim, hidden_dim, **kw)
        self.value = Dense(hidden_dim, hidden_dim, **kw)
        self.out = Dense(hidden_dim, hidden_dim, **kw)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, N, C]; mask [B, 1, 1, N] bool, True = attend to that key."""
        B, N, _ = x.shape
        split = (B, N, self.num_heads, self.head_dim)
        q = self.query(x).reshape(split) / math.sqrt(self.head_dim)
        k, v = self.key(x).reshape(split), self.value(x).reshape(split)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if mask is not None:
            logits = torch.where(mask, logits, torch.finfo(logits.dtype).min)
        weights = torch.softmax(logits, dim=-1)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(B, N, -1))


class EncoderLayer(nn.Module):
    """Post-norm encoder layer (torch `TransformerEncoderLayer` semantics with
    norm_first=False), feed-forward width `hidden_dim`. Dropout applies only
    with `deterministic=False`, which the Trainer never passes."""

    def __init__(self, hidden_dim: int, num_heads: int, dropout: float = 0.1, dtype=torch.float32, device=None):
        super().__init__()
        self.dropout = dropout
        kw = dict(dtype=dtype, device=device)
        self.multi_head_dot_product_attention_0 = MultiHeadDotProductAttention(hidden_dim, num_heads, **kw)
        self.layer_norm_0 = LayerNorm(hidden_dim, **kw)
        self.dense_0 = Dense(hidden_dim, hidden_dim, **kw)
        self.dense_1 = Dense(hidden_dim, hidden_dim, **kw)
        self.layer_norm_1 = LayerNorm(hidden_dim, **kw)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None, deterministic: bool = True) -> torch.Tensor:
        def drop(t):
            return t if deterministic else F.dropout(t, self.dropout, training=True)

        x = self.layer_norm_0(x + drop(self.multi_head_dot_product_attention_0(x, mask)))
        h = self.dense_1(drop(F.relu(self.dense_0(x))))
        return self.layer_norm_1(x + drop(h))


class TransformerVanilla(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int = 64, output_dim: int = 6, num_layers: int = 2, num_heads: int = 2,
                 dropout: float = 0.1, concat_global: bool = False, dtype=torch.float32, device=None):
        super().__init__()
        self.hidden_dim, self.num_layers, self.concat_global, self.dtype = hidden_dim, num_layers, concat_global, dtype
        self.embedding = Dense(in_dim, hidden_dim, dtype=dtype, device=device)
        if concat_global:
            self.cls_token = nn.Parameter(torch.zeros(1, 1, hidden_dim, device=device))
        for i in range(num_layers):
            self.add_module(f"layer_{i}", EncoderLayer(hidden_dim, num_heads, dropout, dtype=dtype, device=device))
        self.fc_out = Dense(hidden_dim * (2 if concat_global else 1), output_dim, device=device)  # f32

    def reset_loose_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        if self.concat_global:
            nn.init.normal_(self.cls_token, 0.0, 1.0, generator=generator)

    def forward(self, graph: HeteroGraph, feats: GraphFeatures, deterministic: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        homo = homogenize(graph)
        x = self.embedding(concat_features(graph, feats))  # [B,Ntot,C]
        B = x.shape[0]
        node_mask = homo.node_mask  # [B,Ntot]

        if self.concat_global:
            x = torch.cat([self.cls_token.to(x.dtype).expand(B, 1, self.hidden_dim), x], dim=1)
            node_mask = torch.cat([torch.ones((B, 1), dtype=node_mask.dtype, device=node_mask.device), node_mask], dim=1)

        attn_mask = node_mask[:, None, None, :] > 0.5  # [B,1,1,N] key mask
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, attn_mask, deterministic)

        start, stop = homo.output_slice(graph)
        if self.concat_global:
            h = x[:, start + 1 : stop + 1]
            h = torch.cat([x[:, :1].expand_as(h), h], dim=-1)
        else:
            h = x[:, start:stop]
        h = h.float()
        return self.fc_out(h), h
