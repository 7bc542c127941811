"""The realigned staging of the bf16 tensor-core bodies, mirrored on the
host (``csrc/realign.cuh``, shared by ``sketch_realign.cu`` and
``gram_realign.cu``).

A bf16 row that starts only 2-byte aligned is staged a 128-column tile at a
time from the aligned-down 16-byte chunks that cover it, then shifted into
place in shared memory.  :func:`realign_shift` is a row's shift and
:func:`realign_plan` what one tile of one row lands and keeps; the CPU tests
hold every column of a row to being staged exactly once over a body's grid.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

STAGE_COLS = 128          # columns of one staged tile
CHUNK = 8                 # entries of a 16-byte chunk


def realign_shift(address: int) -> int:
    """The shift of a bf16 row starting at byte ``address``: (address / 2)
    mod 8, its entries past the 16-byte boundary below it (the source's
    ``shift_of``)."""
    return (address >> 1) & 7


def realign_plan(shift: int, base: int, col1: int
                 ) -> Tuple[List[Tuple[int, bool]],
                            List[Optional[Tuple[int, int]]], bool]:
    """How a realigning body stages one row's tile of columns [base,
    base + 128) in a block whose range ends at column col1, the row's shift
    being ``shift``: ``(chunks, staged, shifted)``.

    ``chunks``: each aligned-down 16-byte chunk landed in the staged row,
    as (its first column, read?): 17 where shift != 0, else 16; read only if
    it starts before col1, else zero-filled.  ``staged``: for each entry j
    of the tile, the (chunk, lane) of the landed entry it takes after the
    realign pass, or None where it is zeroed (column base + j >= col1).
    ``shifted``: whether the pass rewrites the row (shift != 0, or the tile
    ends past col1); else the landed chunks stand as they are."""
    chunks = []
    for c in range(STAGE_COLS // CHUNK + (1 if shift else 0)):
        col = base - shift + CHUNK * c
        chunks.append((col, col < col1))
    staged = [divmod(shift + j, CHUNK) if base + j < col1 else None
              for j in range(STAGE_COLS)]
    return chunks, staged, shift != 0 or col1 - base < STAGE_COLS
