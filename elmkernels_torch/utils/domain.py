"""Domain decomposition: the global (lat, lon) grid and the column axis
over ranks.

Counterpart of ``elmkernels_tpu/utils/domain.py`` (the reference's
``DomainDecomposition``, ``src/utils/utils.hh:13-35``, ``utils.cc:7-69``):
each rank owns a contiguous block of cells and reads its own forcing
hyperslab.  The functions equal the JAX package's on every input.

The port does not pad.  ``column_blocks`` reports the JAX package's
ceil-rule blocks and its padded block size, because XLA's sharding must
divide the column axis evenly and pads it to ``block * n_shards``.  A
``torch.distributed`` rank holds only the real columns of its ``(lo, hi)``
range: its block is the JAX package's block less the pad, and the last
ranks' blocks may be shorter.  A rank whose range is empty has no columns
to run and is refused at setup (:func:`rank_block`).
"""

from __future__ import annotations

import dataclasses
import math


def square_numprocs(nprocs: int) -> tuple[int, int]:
    """Factor nprocs into the most-square (ny, nx) grid (reference:
    ``utils.cc:7-24``)."""
    best = (1, nprocs)
    for ny in range(1, int(math.isqrt(nprocs)) + 1):
        if nprocs % ny == 0:
            best = (ny, nprocs // ny)
    return best


@dataclasses.dataclass(frozen=True)
class DomainDecomposition:
    """This rank's block of the global grid."""
    n_global: tuple[int, int]   # (nlat, nlon)
    start: tuple[int, int]      # block start (lat0, lon0)
    n_local: tuple[int, int]    # block extent (nlat_local, nlon_local)

    @property
    def ncells(self) -> int:
        return self.n_local[0] * self.n_local[1]


def column_blocks(ncol: int, n_shards: int) -> tuple[list[tuple[int, int]],
                                                     int]:
    """Ceil-rule column blocks: ``([(lo, hi), ...], block)``, each shard's
    half-open range over the real columns (shorter for the tail shards,
    possibly empty) and the JAX package's padded block size,
    ``ceil(ncol / n_shards)``.  The port runs each rank on its ``(lo, hi)``
    range and never on the pad."""
    block = -(-ncol // n_shards)
    return ([(min(i * block, ncol), min((i + 1) * block, ncol))
             for i in range(n_shards)], block)


def rank_block(ncol: int, nranks: int, rank: int) -> tuple[int, int]:
    """Rank ``rank``'s ``(lo, hi)`` of :func:`column_blocks`; raises if the
    range is empty."""
    if not 0 <= rank < nranks:
        raise ValueError(f"rank {rank} is not one of {nranks} ranks")
    lo, hi = column_blocks(ncol, nranks)[0][rank]
    if hi <= lo:
        raise ValueError(
            f"ncol={ncol} over {nranks} ranks leaves rank {rank} no column "
            f"(ceil-rule blocks of {-(-ncol // nranks)}): run fewer ranks "
            f"or more columns")
    return lo, hi


def create_domain_decomposition_2d(n_global: tuple[int, int], nprocs: int,
                                   rank: int) -> DomainDecomposition:
    """Block-partition (nlat, nlon) over a (ny, nx) process grid
    (reference: ``utils.cc:46-69``)."""
    ny, nx = square_numprocs(nprocs)
    py, px = rank // nx, rank % nx
    nlat, nlon = n_global

    def block(n, p, np_):
        base, rem = divmod(n, np_)
        start = p * base + min(p, rem)
        size = base + (1 if p < rem else 0)
        return start, size

    lat0, nlat_l = block(nlat, py, ny)
    lon0, nlon_l = block(nlon, px, nx)
    return DomainDecomposition((nlat, nlon), (lat0, lon0), (nlat_l, nlon_l))
