"""Composition of transfer-map chains (counterpart of ``lynx_tpu.ops.folding``)."""

from __future__ import annotations

import torch


def fold_transfer_maps(maps: torch.Tensor) -> torch.Tensor:
    """Compose stacked maps in application order with a balanced binary
    tree: ``ceil(log2(L))`` batched matmuls, pairing as the JAX package does
    so that both sum in the same order.

    :param maps: ``(L, ..., 7, 7)`` tensor where ``maps[0]`` is applied first.
    :return: ``(..., 7, 7)`` composition ``maps[L-1] @ ... @ maps[0]``.
    """
    if maps.ndim < 3:
        raise ValueError(f"Expected (L, ..., 7, 7) maps, got shape {tuple(maps.shape)}")
    while maps.shape[0] > 1:
        n = maps.shape[0]
        even = n - (n % 2)
        paired = torch.matmul(maps[1:even:2], maps[0:even:2])
        maps = torch.cat([paired, maps[-1:]], dim=0) if n % 2 else paired
    return maps[0]
