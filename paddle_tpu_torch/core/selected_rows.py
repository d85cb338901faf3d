"""SelectedRows: row-sparse gradients, the port of
`paddle_tpu/core/selected_rows.py` (reference `phi/core/selected_rows.h`).

A large-vocabulary embedding's backward must not build a dense `[V, H]`
gradient: its cotangent touches only the looked-up rows. A SelectedRows
carries `rows [n]` (int32, one entry per token occurrence, duplicates
kept), `values [n, ...]` and `height` V.

The JAX package merges duplicates at a static size (`jnp.unique(size=n)`,
padded slots given row id `height`, which every scatter drops as out of
bounds). Here an out-of-range index raises on the CPU and asserts on the
card, so:
- `merged_static` / `merged` keep JAX's padded layout (row id `height`,
  zero values) for their callers, and every scatter of the port masks
  the padded slots explicitly;
- the optimizers and clips use `merge_rows`, the same merge cut to the
  unique rows (one host read of their count).
The merge sums each row's occurrences in occurrence order, in float32
(float64 for a float64 table), by `index_put_(accumulate=True)`, which
sorts on the card instead of adding with atomics: the same bits on every
run, so a step replays bit for bit.
"""
from __future__ import annotations

import torch

__all__ = ["SelectedRows", "merge_rows", "merge_rows_static"]


def _acc_dtype(dt):
    return torch.promote_types(dt, torch.float32)


def merge_rows(rows, values, height: int):
    """(u_rows [k] int32 ascending, merged [k, ...]) with each duplicate
    row's values summed in occurrence order, k the number of distinct
    rows below `height` (a padded slot's row id `height` is dropped)."""
    u_rows, inv = torch.unique(rows.long(), sorted=True, return_inverse=True)
    acc = torch.zeros((u_rows.shape[0],) + tuple(values.shape[1:]),
                      dtype=_acc_dtype(values.dtype), device=values.device)
    acc.index_put_((inv.reshape(-1),), values.to(acc.dtype), accumulate=True)
    k = int((u_rows < height).sum())      # padded ids sort last
    return u_rows[:k].to(torch.int32), acc[:k].to(values.dtype)


def merge_rows_static(rows, values, height: int):
    """JAX's static-size merge: (u_rows [n], merged [n, ...]) for n =
    len(rows), the slots past the distinct rows given row id `height`
    and zero values."""
    n = rows.shape[0]
    u, m = merge_rows(rows, values, height)
    k = u.shape[0]
    u_rows = torch.full((n,), int(height), dtype=torch.int32,
                        device=rows.device)
    u_rows[:k] = u
    merged = torch.zeros((n,) + tuple(values.shape[1:]), dtype=values.dtype,
                         device=values.device)
    merged[:k] = m
    return u_rows, merged


class SelectedRows:
    is_selected_rows = True

    def __init__(self, rows, values, height: int):
        self.rows = rows          # [n] int32 tensor
        self.values = values      # [n, ...] tensor
        self.height = int(height)

    @property
    def shape(self):
        return [self.height] + [int(s) for s in self.values.shape[1:]]

    @property
    def dtype(self):
        from ..framework import dtype as dtype_mod

        return dtype_mod.from_torch(self.values.dtype)

    def concat(self, other: "SelectedRows") -> "SelectedRows":
        """Gradient accumulation: the occurrence lists stacked, this one
        first (no merge yet)."""
        if self.height != other.height:
            raise ValueError(f"SelectedRows heights differ: {self.height} "
                             f"and {other.height}")
        return SelectedRows(torch.cat([self.rows, other.rows]),
                            torch.cat([self.values, other.values]),
                            self.height)

    def to_dense(self) -> torch.Tensor:
        """The dense `[height, ...]` gradient (rows summed in; padded
        slots, row id `height`, dropped)."""
        keep = self.rows < self.height
        idx = torch.where(keep, self.rows, 0).long()
        vals = torch.where(keep.reshape((-1,) + (1,) * (self.values.dim() - 1)),
                           self.values, torch.zeros((), dtype=self.values.dtype,
                                                    device=self.values.device))
        z = torch.zeros((self.height,) + tuple(self.values.shape[1:]),
                        dtype=_acc_dtype(self.values.dtype),
                        device=self.values.device)
        z.index_put_((idx,), vals.to(z.dtype), accumulate=True)
        return z.to(self.values.dtype)

    def merged_static(self):
        """(u_rows [n], merged_values [n, ...]) with duplicates summed
        (see `merge_rows_static`)."""
        return merge_rows_static(self.rows, self.values, self.height)

    def merged(self) -> "SelectedRows":
        """A duplicate-free equivalent in JAX's padded layout (padded slots
        carry row id `height` and zero values)."""
        u_rows, merged = self.merged_static()
        return SelectedRows(u_rows, merged, self.height)

    def scaled(self, factor) -> "SelectedRows":
        """Values times a scalar (a clip's or the loss scale's), cast to
        the values' dtype first."""
        if torch.is_tensor(factor):
            factor = factor.to(device=self.values.device,
                               dtype=self.values.dtype)
        return SelectedRows(self.rows, self.values * factor, self.height)

    def sq_sum(self) -> torch.Tensor:
        """The f32 sum of squares of the MERGED gradient (duplicate rows
        summed first: the global norm's contribution)."""
        _, merged = merge_rows(self.rows, self.values, self.height)
        mf = merged.float()
        return torch.sum(mf * mf)

    def numpy(self):
        d = self.to_dense().cpu()
        if d.dtype == torch.bfloat16:
            return d.float().numpy()
        return d.numpy()

    def __repr__(self):
        return (f"SelectedRows(height={self.height}, "
                f"rows={self.rows.shape[0]}, "
                f"values={tuple(self.values.shape)})")

