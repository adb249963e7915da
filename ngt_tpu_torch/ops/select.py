"""Selection on (value, id) keys.

``jax.lax.top_k`` and ``jax.lax.sort`` with several keys order ties by
position, and every caller in the JAX package lays its candidates out so
that position order is id order.  ``torch.topk`` and ``torch.sort`` leave
the order of ties open, so the port orders on an explicit key: the float
value mapped to an order-preserving int32 in the high half of an int64 and
the int32 id in the low half.  Keys are then unique per id, which makes
every selection deterministic and equal to the reference's.
"""

from __future__ import annotations

import torch


def lex_key(d: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """int64 key ordering lexicographically by (d, ids); d float32, ids in
    int32 range (-1 allowed)."""
    bits = d.to(torch.float32).contiguous().view(torch.int32)
    # negative floats: flip the magnitude bits so the int order is the float
    # order (-0.0 sorts just below +0.0)
    bits = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    return (bits.to(torch.int64) << 32) + (ids.to(torch.int64) + (1 << 31))


def sort_lex(d: torch.Tensor, ids: torch.Tensor, *payload: torch.Tensor):
    """Sort the last dim by (d, ids); returns (d, ids, *payload) permuted."""
    order = torch.sort(lex_key(d, ids), dim=-1, stable=True).indices
    return tuple(t.gather(-1, order) for t in (d, ids) + payload)


def topk_lex(d: torch.Tensor, ids: torch.Tensor, k: int):
    """The k smallest entries of the last dim by (d, ids), ascending."""
    pos = torch.topk(lex_key(d, ids), k, dim=-1, largest=False, sorted=True).indices
    return d.gather(-1, pos), ids.gather(-1, pos)


def topk_pos(d: torch.Tensor, k: int):
    """The k smallest entries of the last dim and their int64 positions,
    ties to the lower position (the order of ``jax.lax.top_k(-d, k)``)."""
    pos = torch.arange(d.shape[-1], dtype=torch.int32, device=d.device)
    dd, sel = topk_lex(d, pos.expand_as(d), k)
    return dd, sel.to(torch.int64)
