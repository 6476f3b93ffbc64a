"""Index helpers with the JAX package's out-of-bounds semantics.

- A JAX gather clamps out-of-range indices; a torch gather raises (and on
  CUDA trips a device assert). `gather_clamped` clamps first.
- A JAX scatter with mode="drop" drops out-of-range writes; the tables use
  the capacity as a "drop" sentinel row. `scatter_drop` drops them too.
  Where indices repeat, the LAST write in index order wins, on every
  device (torch's `index_put_` leaves the winner unspecified on CUDA).
- `segment_max` / `segment_min` follow `jax.ops.segment_max/min`: empty
  segments hold the reduction's identity (-inf / +inf, or the integer
  extremes).
"""
from __future__ import annotations

import torch


def gather_clamped(t: torch.Tensor, idx: torch.Tensor, dim: int = 0):
    """t indexed along `dim` by idx (any shape) with idx clamped into range."""
    n = t.shape[dim]
    i = idx.long().clamp(0, n - 1)
    if dim == 0:
        return t[i]
    return t.index_select(dim, i.reshape(-1)).reshape(
        t.shape[:dim] + i.shape + t.shape[dim + 1:])


def scatter_drop(dst: torch.Tensor, idx: torch.Tensor, src) -> torch.Tensor:
    """Copy of dst with dst[idx[k]] = src[k] along dim 0, writes with
    idx outside [0, len(dst)) dropped; on duplicate indices the last k wins."""
    n = dst.shape[0]
    idx = idx.long().reshape(-1)
    if not torch.is_tensor(src):
        src = torch.tensor(src, dtype=dst.dtype, device=dst.device)
    src = src.to(dst.dtype)
    if src.dim() < dst.dim():
        src = src.expand((idx.shape[0],) + dst.shape[1:])
    keep = (idx >= 0) & (idx < n)
    # last occurrence of each index wins: a later k with the same index
    # masks every earlier one
    k = torch.arange(idx.shape[0], device=idx.device)
    key = torch.where(keep, idx, torch.full_like(idx, n))
    last = torch.full((n + 1,), -1, dtype=torch.long, device=idx.device)
    last = last.scatter_reduce(0, key, k, reduce="amax", include_self=True)
    # every write that does not win goes to a dump row past the end, so the
    # scatter needs no boolean indexing (no host sync on a GPU)
    key = torch.where(keep & (last[key] == k), key, torch.full_like(key, n))
    out = torch.cat([dst, dst.new_zeros((1,) + dst.shape[1:])])
    out[key] = src
    return out[:n]


def _segment(data, seg, n, reduce, fill):
    out = torch.full((n,) + data.shape[1:], fill, dtype=data.dtype,
                     device=data.device)
    s = seg.long()
    if data.dim() > 1:
        s = s.reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    return out.scatter_reduce(0, s, data, reduce=reduce, include_self=False)


def _lowest(dtype):
    return -float("inf") if dtype.is_floating_point else torch.iinfo(dtype).min


def _highest(dtype):
    return float("inf") if dtype.is_floating_point else torch.iinfo(dtype).max


def segment_max(data, seg, num_segments: int):
    return _segment(data, seg, num_segments, "amax", _lowest(data.dtype))


def segment_min(data, seg, num_segments: int):
    return _segment(data, seg, num_segments, "amin", _highest(data.dtype))


def to_int32(x: torch.Tensor) -> torch.Tensor:
    """Float -> int32 with XLA's conversion semantics (NaN -> 0, out-of-range
    values saturate); a plain `.to(torch.int32)` of NaN or inf is undefined."""
    x = torch.nan_to_num(x, nan=0.0, posinf=2.0 ** 31, neginf=-2.0 ** 31)
    # 2147483520 is the largest f32 below 2^31; at or above 2^31 saturate
    out = x.clamp(-2.0 ** 31, 2147483520.0).to(torch.int32)
    return torch.where(x >= 2.0 ** 31, torch.full_like(out, 2 ** 31 - 1), out)


def top_k_stable(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries along the last axis; ties
    go to the lower index, as `jax.lax.top_k` does (torch.topk promises no
    tie order)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def nonzero_padded(mask: torch.Tensor, size: int, fill: int):
    """`jnp.nonzero(mask, size=size, fill_value=fill)` along the last axis
    of a mask (any leading batch axes), without a host sync: each True
    entry scatters its index to its rank; entries past `size` land in a
    discarded dump slot."""
    n = mask.shape[-1]
    rank = torch.cumsum(mask.long(), -1) - 1
    dest = torch.where(mask & (rank < size), rank, torch.full_like(rank, size))
    out = torch.full(mask.shape[:-1] + (size + 1,), fill, dtype=torch.long,
                     device=mask.device)
    out.scatter_(-1, dest, torch.arange(n, device=mask.device).expand_as(dest))
    return out[..., :size]


def take(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-sequence row gather: tab (B, N, ...) indexed by idx (B, ...) in
    each sequence's own rows, tab[b, idx[b, ...]]."""
    B = tab.shape[0]
    b = torch.arange(B, device=idx.device).view((B,) + (1,) * (idx.dim() - 1))
    return tab[b, idx.long()]


def seq_of_rows(B: int, n: int, device) -> torch.Tensor:
    """(B * n,) sequence index of each row of a (B, n) table flattened."""
    return torch.arange(B, device=device).repeat_interleave(n)


def flat_rows(idx: torch.Tensor, n: int, valid=None) -> torch.Tensor:
    """Rows idx (B, ...) of per-sequence tables of n rows, as rows of the
    tables flattened to (B * n, ...); where `valid` is False (or idx lies
    outside [0, n)) the row is B * n, which a scatter_drop drops."""
    B = idx.shape[0]
    base = (torch.arange(B, device=idx.device) * n).view(
        (B,) + (1,) * (idx.dim() - 1))
    ok = (idx >= 0) & (idx < n)
    if valid is not None:
        ok = ok & valid
    return torch.where(ok, idx.long() + base, torch.full_like(idx.long(), B * n))
