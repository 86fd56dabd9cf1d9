"""Vectorized VLC emission: quantized zigzag blocks -> (code, len) tensors.

This is the data-parallel replacement for the reference's per-coefficient
bitvector appends (vlc.c:315-385, image_processing.c:400-433,
mpeg1_blk.c:67-113): every 8x8 block yields a fixed 65-slot stream of
(codeword, bitlength) pairs — 1 DC slot, 63 AC slots (one per zigzag
position; zero length where nothing is emitted), 1 EOB slot — with **no
data-dependent control flow**, so whole frames encode as one fused XLA
program.  Each slot's codeword fits in uint32 (max 28 bits: escape 6 +
run 6 + 16 level bits).

Run-lengths are recovered with a cumulative-max scan over the positions
of nonzero coefficients; the compat truncation quirk (Q5) becomes a
cumulative-or mask.  Validated slot-for-slot against the scalar oracle in
ops/rle_vlc.py.

Backend-agnostic: pass xp=numpy for the host oracle or xp=jax.numpy under
jit (shapes static, all ops elementwise/gather/scan).
"""

from __future__ import annotations

import numpy as np

from ec504_imageencoder_tpu.utils.tables import (
    AC_CODE_COMPAT,
    AC_CODE_CORRECT,
    AC_LEN_COMPAT,
    AC_LEN_CORRECT,
    DC_SIZE_CHROMA_CODE,
    DC_SIZE_CHROMA_LEN,
    DC_SIZE_LUMA_CODE,
    DC_SIZE_LUMA_LEN,
)

BLOCK_SLOTS = 65  # 1 DC + 63 AC + 1 EOB

# stacked DC-size tables indexed by [is_luma, size]
_DC_CODE_STACK = np.stack([DC_SIZE_CHROMA_CODE, DC_SIZE_LUMA_CODE]).astype(np.uint32)
_DC_LEN_STACK = np.stack([DC_SIZE_CHROMA_LEN, DC_SIZE_LUMA_LEN]).astype(np.int32)


def _cummax(a, xp):
    if xp is np:
        return np.maximum.accumulate(a, axis=-1)
    import jax

    return jax.lax.cummax(a, axis=a.ndim - 1)


def _runs(levels, xp):
    """zeros_before[i] for every position of a (..., 64) zigzag block."""
    nz = levels != 0
    idx = xp.arange(64, dtype=xp.int32)
    marked = xp.where(nz, idx, xp.int32(-1))
    prev_incl = _cummax(marked, xp)
    prev = xp.concatenate(
        [xp.full(levels.shape[:-1] + (1,), -1, dtype=xp.int32), prev_incl[..., :-1]],
        axis=-1,
    )
    return nz, idx - prev - 1


def _bitlength8(v, xp):
    """bit_length(v) for v in [0, 255], vectorized; 0 -> 0."""
    sz = xp.zeros(v.shape, dtype=xp.int32)
    for k in range(8):
        sz = sz + (v >= (1 << k)).astype(xp.int32)
    return sz


def _escape_codes(ri, al, sign, xp):
    """Packed escape codeword + length: 6-bit escape, 6-bit run, level bytes.

    Semantics of vlc.c:347-376 (identical in compat and correct modes; the
    byte layout happens to match ISO 11172-2 table B.5f).
    """
    al = al.astype(xp.int32)
    lo = xp.where(sign, (256 - al) & 0xFF, al & 0xFF).astype(xp.uint32)
    hi = xp.where(sign, xp.uint32(0x80), xp.uint32(0x00))
    base = (xp.uint32(1 << 6) | ri.astype(xp.uint32))  # 12-bit escape+run
    short = (base << 8) | lo
    long_ = (base << 16) | (hi << 8) | lo
    is_long = al >= 128
    code = xp.where(is_long, long_, short)
    length = xp.where(is_long, xp.int32(28), xp.int32(20))
    return code, length


def _ac_table(ri, al, compat: bool, xp):
    """(code, len) from table B.5c/d; len 0 where no row exists.

    Under numpy this is a plain dense-LUT gather; under JAX it gathers
    from the rank-compressed 112-entry table (ops/vlc_lut.py).
    """
    if xp is np:
        ri_c = np.clip(ri, 0, 31)
        al_c = np.clip(al, 0, 40)
        in_range = (ri <= 31) & (al <= 40)
        if compat:
            code = AC_CODE_COMPAT[ri_c, al_c]
            length = AC_LEN_COMPAT[ri_c, al_c]
        else:
            code = AC_CODE_CORRECT[ri_c, al_c]
            length = AC_LEN_CORRECT[ri_c, al_c]
        return np.where(in_range, code, 0), np.where(in_range, length, 0)
    from ec504_imageencoder_tpu.ops import vlc_lut

    return vlc_lut.ac_table_lookup(ri, al, xp, compat=compat)


def ac_codes_compat(levels_ac, zeros_before_ac, xp=np):
    """Per-position AC (code, len) with reference emission rules.

    levels_ac / zeros_before_ac: (..., 63) int32 for zigzag positions 1..63.
    Zero-length where nothing is emitted.  Caller applies the truncation
    mask; this handles pairs with zeros_before >= 1 only (positions where
    zeros_before == 0 are dropped by the caller's Q5 mask anyway).
    """
    lvl = levels_ac.astype(xp.int32)
    sign = lvl < 0
    al = xp.abs(lvl)
    ri = xp.maximum(zeros_before_ac - 1, 0)

    special = (ri == 0) & (al == 1)
    t_code, t_len = _ac_table(ri, al, compat=True, xp=xp)
    in_table = (~special) & (t_len > 0)

    e_code, e_len = _escape_codes(ri, al, sign, xp)

    code = xp.where(special, xp.uint32(0b11), xp.where(in_table, t_code, e_code))
    length = xp.where(
        special, xp.int32(2), xp.where(in_table, t_len, e_len)
    )
    return code, length


def ac_codes_correct(levels_ac, zeros_before_ac, xp=np):
    """ISO-compliant AC coding: table code + sign bit, true run index."""
    lvl = levels_ac.astype(xp.int32)
    sign = lvl < 0
    sbit = sign.astype(xp.uint32)
    al = xp.abs(lvl)
    ri = zeros_before_ac  # true run, 0-based

    special = (ri == 0) & (al == 1)  # '11s' (never first inside intra blocks)
    t_code0, t_len0 = _ac_table(ri, al, compat=False, xp=xp)
    t_code = (t_code0 << 1) | sbit
    t_len = t_len0 + 1
    in_table = (~special) & (t_len > 1)

    e_code, e_len = _escape_codes(ri, al, sign, xp)

    code = xp.where(
        special, xp.uint32(0b110) | sbit, xp.where(in_table, t_code, e_code)
    )
    length = xp.where(special, xp.int32(3), xp.where(in_table, t_len, e_len))
    return code, length


def _dc_table(luma_i, sz, xp):
    """dct_dc_size (code, len)."""
    if xp is np:
        return _DC_CODE_STACK[luma_i, sz], _DC_LEN_STACK[luma_i, sz]
    from ec504_imageencoder_tpu.ops import vlc_lut

    return vlc_lut.dc_size_lookup(luma_i, sz, xp)


def block_streams_compat(zz, is_luma, xp=np):
    """(..., 64) quantized zigzag + (...,) luma flags -> (..., 65) code/len.

    Slot 0: DC (size VLC fused with magnitude bits); slots 1..63: AC per
    zigzag position with the Q5 truncation mask; slot 64: EOB.
    """
    zz = zz.astype(xp.int32)
    nz, zeros_before = _runs(zz, xp)
    dc = zz[..., 0]

    # --- DC slot (mpeg1_blk.c:73-95 semantics) ---------------------------
    dc_nz = dc != 0
    adc = xp.abs(dc)
    low = adc & 0xFF
    sz = xp.maximum(_bitlength8(low, xp), 1)
    coe = xp.where(dc < 0, adc ^ (1 << (sz - 1)), adc)
    dc_bits = (coe & ((1 << sz) - 1)).astype(xp.uint32)
    luma_i = is_luma.astype(xp.int32) if hasattr(is_luma, "astype") else xp.int32(int(is_luma))
    sz_eff = xp.where(dc_nz, sz, 0)
    size_code, size_len = _dc_table(luma_i, sz_eff, xp)
    fused = (size_code << sz.astype(xp.uint32)) | dc_bits
    dc_code = xp.where(dc_nz, fused, size_code)
    dc_len = xp.where(dc_nz, size_len + sz, size_len)

    # --- AC slots with compat truncation (Q5) ----------------------------
    lvl_ac = zz[..., 1:]
    zb_ac = zeros_before[..., 1:]
    nz_ac = nz[..., 1:]
    bad = nz_ac & (zb_ac == 0)
    dropped = _cummax(bad.astype(xp.int32), xp) > 0  # inclusive cum-or
    emit = nz_ac & ~dropped
    ac_code, ac_len = ac_codes_compat(lvl_ac, zb_ac, xp)
    ac_code = xp.where(emit, ac_code, xp.uint32(0))
    ac_len = xp.where(emit, ac_len, xp.int32(0))

    # --- EOB slot --------------------------------------------------------
    eob_code = xp.full(dc.shape + (1,), 0b10, dtype=xp.uint32)
    eob_len = xp.full(dc.shape + (1,), 2, dtype=xp.int32)

    codes = xp.concatenate(
        [dc_code[..., None].astype(xp.uint32), ac_code, eob_code], axis=-1
    )
    lens = xp.concatenate([dc_len[..., None], ac_len, eob_len], axis=-1)
    return codes, lens


def block_streams_correct64(zz, dc_pred, is_luma, xp=np, mb_first=None):
    """ISO intra block emission in a lane-aligned 64-slot layout.

    Bit-identical stream content to `block_streams_correct`, but with
    exactly one slot per zigzag position and no concatenates — the EOB
    code is folded into slot 63 ((code<<2)|'10') and, where `mb_first`
    is set (the first block of a macroblock), the 2-bit macroblock header
    '11' (address increment 1 + intra type, mpeg1_blk.c:38-58 semantics)
    is folded into the DC slot.  A 64-wide last axis makes the slot
    stream of a slice a plain reshape of the block tensor.

    zz: (..., 64) quantized zigzag; dc_pred: (...,) DC predictors;
    mb_first: optional (...,) bool/int mask.  Returns (codes, lens) of
    shape (..., 64).
    """
    zz = zz.astype(xp.int32)
    nz, _ = _runs(zz, xp)
    dc = zz[..., 0]
    diff = dc - dc_pred

    adiff = xp.abs(diff)
    sz = _bitlength8(xp.clip(adiff, 0, 255), xp)
    v = xp.where(diff >= 0, diff, diff + (1 << sz) - 1)
    dc_bits = (v & ((1 << sz) - 1)).astype(xp.uint32)
    luma_i = is_luma.astype(xp.int32) if hasattr(is_luma, "astype") else xp.int32(int(is_luma))
    size_code, size_len = _dc_table(luma_i, sz, xp)
    dc_code = xp.where(
        sz > 0, (size_code << sz.astype(xp.uint32)) | dc_bits, size_code
    )
    dc_len = size_len + sz
    if mb_first is not None:
        first = mb_first.astype(bool) if hasattr(mb_first, "astype") else mb_first
        dc_code = xp.where(
            first, (xp.uint32(0b11) << dc_len.astype(xp.uint32)) | dc_code, dc_code
        )
        dc_len = dc_len + 2 * first.astype(xp.int32)

    # AC runs: computed over all 64 lanes with position 0 forced nonzero
    # (lane 0's own result is discarded — the DC slot replaces it below).
    lane = xp.arange(64, dtype=xp.int32)
    forced = xp.where(lane == 0, xp.int32(1), zz)
    _, zb_all = _runs(forced, xp)
    ac_code, ac_len = ac_codes_correct(zz, zb_all, xp)
    ac_code = xp.where(nz, ac_code, xp.uint32(0))
    ac_len = xp.where(nz, ac_len, xp.int32(0))

    # fold the end-of-block code '10' into slot 63
    ac_code = xp.where(lane == 63, (ac_code << 2) | xp.uint32(0b10), ac_code)
    ac_len = xp.where(lane == 63, ac_len + 2, ac_len)

    codes = xp.where(lane == 0, dc_code[..., None].astype(xp.uint32), ac_code)
    lens = xp.where(lane == 0, dc_len[..., None], ac_len)
    return codes, lens


def block_streams_correct(zz, dc_pred, is_luma, xp=np):
    """ISO-compliant intra block emission.

    zz: (..., 64) quantized zigzag; dc_pred: (...,) predictor values (the
    previous same-component DC in decoding order, 128-reset at slice
    start — computed by the caller with a shifted subtract, no scan).
    Returns (codes, lens) of shape (..., 65).
    """
    zz = zz.astype(xp.int32)
    nz, zeros_before = _runs(zz, xp)
    dc = zz[..., 0]
    diff = dc - dc_pred

    adiff = xp.abs(diff)
    sz = _bitlength8(xp.clip(adiff, 0, 255), xp)  # dc_size 0..8
    v = xp.where(diff >= 0, diff, diff + (1 << sz) - 1)
    dc_bits = (v & ((1 << sz) - 1)).astype(xp.uint32)
    luma_i = is_luma.astype(xp.int32) if hasattr(is_luma, "astype") else xp.int32(int(is_luma))
    size_code, size_len = _dc_table(luma_i, sz, xp)
    dc_code = xp.where(
        sz > 0, (size_code << sz.astype(xp.uint32)) | dc_bits, size_code
    )
    dc_len = size_len + sz

    lvl_ac = zz[..., 1:]
    # True AC run: zero ACs since the previous nonzero AC (or since position
    # 1 for the first).  Treat position 0 as always-nonzero so the scan
    # measures runs purely within the AC sequence.
    forced = xp.concatenate(
        [xp.ones(dc.shape + (1,), dtype=xp.int32), zz[..., 1:]], axis=-1
    )
    _, zb_all = _runs(forced, xp)
    zb_ac = zb_all[..., 1:]
    nz_ac = nz[..., 1:]
    ac_code, ac_len = ac_codes_correct(lvl_ac, zb_ac, xp)
    ac_code = xp.where(nz_ac, ac_code, xp.uint32(0))
    ac_len = xp.where(nz_ac, ac_len, xp.int32(0))

    eob_code = xp.full(dc.shape + (1,), 0b10, dtype=xp.uint32)
    eob_len = xp.full(dc.shape + (1,), 2, dtype=xp.int32)

    codes = xp.concatenate(
        [dc_code[..., None].astype(xp.uint32), ac_code, eob_code], axis=-1
    )
    lens = xp.concatenate([dc_len[..., None], ac_len, eob_len], axis=-1)
    return codes, lens
