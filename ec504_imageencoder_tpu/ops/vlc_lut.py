"""Table lookups for the VLC stage.

The ISO AC table (run, |level|) rank-compresses to 111 rows with a
*closed-form* base/count (the same layout as the reference's two-level
blk_rle_lookup index, vlc.c:172-174), so the device lookup is one gather
from a 112-entry `code | len << 16` table instead of a (32, 41) 2-D LUT.
"""

from __future__ import annotations

import functools

import numpy as np

from ec504_imageencoder_tpu.utils import tables

# ---------------------------------------------------------------------------
# rank layout of the AC run/level table — the same two-level scheme as the
# reference's blk_rle_lookup (vlc.c:172-174), but with the base offsets
# recovered by closed form instead of an index table.


def _build_rank_tables():
    """rank -> (code, len) arrays for the correct + compat AC tables, plus
    verified base/count vectors derived from the LUTs themselves."""
    base = np.zeros(33, np.int32)
    counts = np.zeros(32, np.int32)
    rank_code = np.zeros(128, np.uint32)
    rank_len = np.zeros(128, np.int32)
    r = 0
    for run in range(32):
        first = 2 if run == 0 else 1
        base[run] = r
        n = 0
        for level in range(first, 41):
            if tables.AC_LEN_CORRECT[run, level]:
                rank_code[r] = tables.AC_CODE_CORRECT[run, level]
                rank_len[r] = tables.AC_LEN_CORRECT[run, level]
                r += 1
                n += 1
        counts[run] = n
    base[32] = r
    return base[:32], counts, rank_code, rank_len


AC_RANK_BASE, AC_RANK_COUNT, AC_RANK_CODE, AC_RANK_LEN = _build_rank_tables()


def rank_base(ri, xp):
    """Closed-form AC_RANK_BASE[ri] (asserted against the table below)."""
    b = xp.where(ri <= 16, 2 * ri + 61, ri + 78)  # runs 7..16 / 17..31
    for v, val in [(6, 72), (5, 69), (4, 66), (3, 62), (2, 57), (1, 39), (0, 0)]:
        b = xp.where(ri == v, val, b)
    return b


def rank_count(ri, xp):
    c = xp.where(ri <= 16, 2, 1)
    for v, val in [(6, 3), (5, 3), (4, 3), (3, 4), (2, 5), (1, 18), (0, 39)]:
        c = xp.where(ri == v, val, c)
    return c


# sanity: closed forms must match the generated layout
assert np.array_equal(rank_base(np.arange(32), np), AC_RANK_BASE), AC_RANK_BASE
assert np.array_equal(rank_count(np.arange(32), np), AC_RANK_COUNT)


def ac_packed_table() -> np.ndarray:
    """(112,) u32 `code | len<<16` rank-compressed AC table (111 real rows
    + 1 pad)."""
    return (AC_RANK_CODE | (AC_RANK_LEN.astype(np.uint32) << 16))[:112]


def table_lookup(idx, values_u32: np.ndarray, xp):
    """values_u32[idx] for a small constant table, indices clipped to it.

    A plain gather over the replicated table: it partitions trivially
    under GSPMD, so a sharded step stays collective-free
    (tests/test_sharding.py asserts this on the compiled HLO)."""
    table = xp.asarray(values_u32)
    return table[xp.clip(idx, 0, values_u32.shape[0] - 1)]


def ac_table_lookup(ri, al, xp, compat: bool = False):
    """(code, len) from table B.5c/d without sign bit; len 0 = no row.

    ri: run index >= 0; al: |level|.  `compat` reproduces the reference's
    run-0 off-by-one (vlc.c:329-338): the row offset is always al-1, so
    for run 0 level L the level-(L+1) code is returned and L=40 escapes.
    """
    ric = xp.clip(ri, 0, 31)
    base = rank_base(ric, xp)
    count = rank_count(ric, xp)
    if compat:
        k = al - 1
    else:
        k = al - xp.where(ri == 0, 2, 1)
    valid = (ri <= 31) & (k >= 0) & (k < count)
    rank = xp.clip(base + k, 0, 111)  # 111 real rows
    vals = table_lookup(rank, ac_packed_table(), xp)
    code = vals & xp.uint32(0xFFFF)
    length = (vals >> 16).astype(xp.int32)
    code = xp.where(valid, code, xp.uint32(0))
    length = xp.where(valid, length, 0)
    if compat:
        # the reference's transcription typos (utils/tables._AC_REF_ERRATA)
        # are rows of the compat table only
        for (run, level), bits in tables._AC_REF_ERRATA.items():
            hit = (ri == run) & (al == level)
            code = xp.where(hit, xp.uint32(int(bits, 2)), code)
            length = xp.where(hit, len(bits), length)
    return code, length


@functools.lru_cache(maxsize=None)
def _dc_packed():
    # combined index: is_luma * 16 + size (sizes 0..8) -> 32 entries padded;
    # value = code | len << 8 (codes <= 7 bits, lens <= 7)
    code = np.zeros(32, np.uint32)
    length = np.zeros(32, np.uint32)
    code[0:9] = tables.DC_SIZE_CHROMA_CODE
    length[0:9] = tables.DC_SIZE_CHROMA_LEN
    code[16:25] = tables.DC_SIZE_LUMA_CODE
    length[16:25] = tables.DC_SIZE_LUMA_LEN
    return code | (length << 8)


def dc_size_lookup(is_luma_i, size, xp):
    """(code, len) of the dct_dc_size VLC, both components."""
    idx = is_luma_i * 16 + size
    vals = table_lookup(idx, _dc_packed(), xp)
    return vals & xp.uint32(0xFF), (vals >> 8).astype(xp.int32)
