"""Open-addressing hash table over batched voxel coordinates.

Port of `mink_octtree_stablediffusion_tpu/ops/hashtable.py`, bit for bit:

  * key    — (batch, x1..xD) packed injectively into two 32-bit lanes;
  * build  — masked scatter-min rounds (linear probing; a contested slot
             goes to the lowest row index) until every valid row owns a
             slot;
  * lookup — linear probing from the hash slot, stopping at the key or
             at the first empty slot (one exists: the table is sized to
             at most 50% load).

PyTorch's ``uint32`` lacks most arithmetic, so both lanes and the murmur
mix are carried in ``int64`` and masked to 32 bits after every shift and
multiply; JAX's ``>>`` on ``uint32`` is a logical shift, which a right
shift of a non-negative ``int64`` is.  The JAX package builds the table
in XLA (no Pallas kernel); here it is plain PyTorch, one host read of
"any row left?" per round.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

_INT32_MAX = 2 ** 31 - 1
_M32 = 0xFFFFFFFF


class HashTable(NamedTuple):
    """Immutable coordinate → row-index map."""

    slots: torch.Tensor  # int32[T]: row index, or -1 (empty)
    key_hi: torch.Tensor  # int64[N]: packed key of each row, high lane
    key_lo: torch.Tensor  # int64[N]: low lane
    rounds: int = 0  # scatter rounds the build took

    @property
    def table_size(self) -> int:
        return self.slots.shape[0]


def _field_width(ndim: int) -> int:
    """Bits per packed field; (1 + ndim) fields share 64 bits."""
    return 64 // (1 + ndim)


def pack_keys(coords: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack [N, 1+D] int32 coords into two 32-bit lanes (``int64`` tensors
    holding values in [0, 2³²)).  Each field gets ``64 // (1+D)`` bits;
    spatial coordinates are offset by half the field's range (D=3: 16-bit
    fields, coordinates in [-32768, 32767]); for D=2 the 21-bit fields
    straddle the lane boundary."""
    n, nf = coords.shape
    w = _field_width(nf - 1)
    fmask = (1 << w) - 1 if w < 32 else _M32
    c = coords.to(torch.int64)
    lo = torch.zeros(n, dtype=torch.int64, device=coords.device)
    hi = torch.zeros_like(lo)
    for i in range(nf):
        off = 0 if i == 0 else 1 << (w - 1)
        # int32 + offset wrapped into uint32 (JAX's astype), then masked:
        # two's complement makes both one mask of the int64 value
        v = (c[:, i] + off) & fmask
        p = i * w
        if p < 32:
            lo = lo | ((v << p) & _M32)
            if p + w > 32:
                hi = hi | (v >> (32 - p))
        else:
            hi = hi | ((v << (p - 32)) & _M32)
    return hi, lo


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``a · c mod 2³²`` for ``a`` in [0, 2³²) without leaving ``int64``:
    the constant is split into 16-bit halves."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _hash(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """murmur3-style avalanche of the two key lanes → [0, 2³²)."""
    h = _mul32(lo, 0xCC9E2D51)
    h = _mul32(h ^ (h >> 15), 0x1B873593)
    h = h ^ _mul32(hi, 0x9E3779B1)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    return h ^ (h >> 13)


def table_size_for(capacity: int) -> int:
    """Power-of-two table size at ≤ 50% load."""
    t = 1
    while t < 2 * capacity:
        t *= 2
    return max(t, 16)


def build_table(coords: torch.Tensor, valid: torch.Tensor,
                table_size: int | None = None) -> HashTable:
    """Insert every valid row of ``coords`` [N, 1+D] into a fresh table.

    Valid rows must be unique (grids are deduplicated); a duplicate key
    would get its own slot and lookups would return the first probed."""
    n = coords.shape[0]
    t = table_size or table_size_for(n)
    if t & (t - 1):
        raise ValueError("table size must be a power of two")
    dev = coords.device
    hi, lo = pack_keys(coords)
    rows = torch.arange(n, dtype=torch.int32, device=dev)
    slot = (_hash(hi, lo) & (t - 1))
    # slot t is a trash slot for the masked-out scatters
    table = torch.full((t + 1,), _INT32_MAX, dtype=torch.int32, device=dev)
    remaining = valid.clone()
    it = 0
    while it < t + n and bool(remaining.any()):
        attempt = remaining & (table[slot] == _INT32_MAX)
        dest = torch.where(attempt, slot, t)
        table.scatter_reduce_(0, dest, rows, "amin")
        won = attempt & (table[slot] == rows)
        remaining = remaining & ~won
        slot = torch.where(remaining, (slot + 1) & (t - 1), slot)
        it += 1
    table = table[:t]
    slots = torch.where(table == _INT32_MAX, -1, table)
    return HashTable(slots=slots, key_hi=hi, key_lo=lo, rounds=it)


def probe(table: HashTable, coords: torch.Tensor,
          valid: torch.Tensor | None = None):
    """``lookup`` with its cost: (rows, probe rounds, each query's probe
    length, 0 for an invalid query)."""
    m = coords.shape[0]
    t = table.table_size
    qhi, qlo = pack_keys(coords)
    slot = _hash(qhi, qlo) & (t - 1)
    active = (torch.ones(m, dtype=torch.bool, device=coords.device)
              if valid is None else valid.clone())
    result = torch.full((m,), -1, dtype=torch.int32, device=coords.device)
    probes = torch.zeros(m, dtype=torch.int32, device=coords.device)
    it = 0
    while it < t and bool(active.any()):
        row = table.slots[slot]
        present = row >= 0
        r = row.clamp(min=0).long()
        match = present & (table.key_hi[r] == qhi) & (table.key_lo[r] == qlo)
        result = torch.where(active & match, row, result)
        probes = probes + active.to(torch.int32)
        active = active & present & ~match
        slot = (slot + 1) & (t - 1)
        it += 1
    return result, it, probes


def lookup(table: HashTable, coords: torch.Tensor,
           valid: torch.Tensor | None = None) -> torch.Tensor:
    """Row indices of ``coords`` [M, 1+D] in the table; -1 where absent."""
    return probe(table, coords, valid)[0]
