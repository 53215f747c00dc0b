"""
The table lookups of upstream's generated solvers (optim.c:332-480), in
plain PyTorch: floor / ceil indices clamped to the table, alpha clamped to
[0, 1], the angle lookup along the short angular distance.

A table is shared by every scenario, ``(n,)``, or one a scenario, ``(B,
n)``; a query carries the scenario first, ``(B, ...)``.  Written as
index-and-clamp formulas, autograd gives them upstream's derivatives: the
slope ``v1 - v0`` in the query, none of second order.
"""

import math

import torch


def _indices(q, n):
    qs = torch.nan_to_num(q, nan=0.0)
    i0 = torch.clamp(torch.floor(qs), 0, n - 1)
    i1 = torch.clamp(torch.ceil(qs), 0, n - 1)
    return i0.long(), i1.long(), torch.clamp(q - i0, 0.0, 1.0)


def _take(table, idx):
    if table.dim() == 1:
        return table[idx]
    B = table.shape[0]
    return torch.gather(table, 1, idx.reshape(B, -1)).reshape(idx.shape)


def lerp(x0, dx, x, table):
    i0, i1, a = _indices((x - x0) / dx, table.shape[-1])
    v0, v1 = _take(table, i0), _take(table, i1)
    return v0 + a * (v1 - v0)


def short_angle_dist(a0, a1):
    return torch.remainder((a1 - a0) + math.pi, 2 * math.pi) - math.pi


def lerp_angle(x0, dx, x, table):
    n = table.shape[-1]
    i0, i1, a = _indices(torch.clamp((x - x0) / dx, 0.0, n - 1.0), n)
    v0, v1 = _take(table, i0), _take(table, i1)
    return v0 + short_angle_dist(v0, v1) * a
