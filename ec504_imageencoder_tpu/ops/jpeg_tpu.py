"""JPEG decode back-half as device array ops (the device side of the
hybrid decoder).

The host's entropy decode (io/native stb_compat_jpeg.cpp, COEFFS stage)
is inherently serial; everything after it is dense block math — exactly
what this framework is best at.  These ops reproduce the native decoder's
arithmetic bit-for-bit so the hybrid pipeline stays pixel-identical to
stb_image (the compat gate's requirement):

  * `islow_idct`   — the libjpeg "islow" integer IDCT at stb's fixed-point
                     scales (column pass +512 >> 10, row pass
                     +65536+(128<<17) >> 17; stb_image.h:2430-2523),
  * `upsample2x_triangular` — JFIF-centered triangular 2x chroma
                     upsampling with truncating >>2/>>4 descales
                     (stb_image.h:3454-3527),
  * `ycbcr_to_rgb_fixed` — 20-bit fixed-point YCbCr->RGB including the
                     green-channel "& 0xffff0000" truncation quirk
                     (stb_image.h:3659-3683).

All functions are backend-agnostic (xp = numpy or jax.numpy) and
shape-static, so `decode_rgb_from_coeffs` jits into one XLA program.
Everything is int32; right shifts on negatives are arithmetic in both
numpy and XLA, matching gcc.

The DC-only column shortcut in the native decoder (idct_block) is
numerically identical to the general path (the +512 rounding bias
vanishes under >>10 for multiples of 4096), so the vectorized form needs
no data-dependent branch.
"""

from __future__ import annotations

import numpy as np


def _f2f(x: float) -> int:
    return int(x * 4096 + 0.5)


def _idct_1d(s, xp):
    """One 8-point islow pass.  s: sequence of 8 int32 arrays (same
    shape); returns (x0..x3, t0..t3) per jidctint's even/odd split."""
    s0, s1, s2, s3, s4, s5, s6, s7 = s
    p1 = (s2 + s6) * _f2f(0.5411961)
    u2 = p1 + s6 * _f2f(-1.847759065)
    u3 = p1 + s2 * _f2f(0.765366865)
    ev0 = (s0 + s4) * 4096
    ev1 = (s0 - s4) * 4096
    x0 = ev0 + u3
    x3 = ev0 - u3
    x1 = ev1 + u2
    x2 = ev1 - u2
    a0, a1, a2, a3 = s7, s5, s3, s1
    q3 = a0 + a2
    q4 = a1 + a3
    q1 = a0 + a3
    q2 = a1 + a2
    q5 = (q3 + q4) * _f2f(1.175875602)
    t0 = a0 * _f2f(0.298631336)
    t1 = a1 * _f2f(2.053119869)
    t2 = a2 * _f2f(3.072711026)
    t3 = a3 * _f2f(1.501321110)
    q1 = q5 + q1 * _f2f(-0.899976223)
    q2 = q5 + q2 * _f2f(-2.562915447)
    q3 = q3 * _f2f(-1.961570560)
    q4 = q4 * _f2f(-0.390180644)
    t3 = t3 + q1 + q4
    t2 = t2 + q2 + q3
    t1 = t1 + q2 + q4
    t0 = t0 + q1 + q3
    return x0, x1, x2, x3, t0, t1, t2, t3


def islow_idct(blocks, xp=np):
    """(..., 64) int dequantized natural-order coefficients -> (..., 8, 8)
    uint8 pixels, bit-exact vs the native idct_block."""
    d = blocks.astype(xp.int32).reshape(blocks.shape[:-1] + (8, 8))
    # column pass: 1-D over rows, per column
    cols = [d[..., r, :] for r in range(8)]
    x0, x1, x2, x3, t0, t1, t2, t3 = _idct_1d(cols, xp)
    x0, x1, x2, x3 = x0 + 512, x1 + 512, x2 + 512, x3 + 512
    v = [
        (x0 + t3) >> 10,
        (x1 + t2) >> 10,
        (x2 + t1) >> 10,
        (x3 + t0) >> 10,
        (x3 - t0) >> 10,
        (x2 - t1) >> 10,
        (x1 - t2) >> 10,
        (x0 - t3) >> 10,
    ]  # v[k]: (..., 8) = row k across columns
    # row pass: 1-D over columns, per row
    rows = xp.stack(v, axis=-2)  # (..., 8, 8)
    ins = [rows[..., :, c] for c in range(8)]
    x0, x1, x2, x3, t0, t1, t2, t3 = _idct_1d(ins, xp)
    bias = 65536 + (128 << 17)
    x0, x1, x2, x3 = x0 + bias, x1 + bias, x2 + bias, x3 + bias
    o = [
        (x0 + t3) >> 17,
        (x1 + t2) >> 17,
        (x2 + t1) >> 17,
        (x3 + t0) >> 17,
        (x3 - t0) >> 17,
        (x2 - t1) >> 17,
        (x1 - t2) >> 17,
        (x0 - t3) >> 17,
    ]  # o[c]: (..., 8) = column c across rows
    out = xp.stack(o, axis=-1)  # (..., 8row, 8col)
    return xp.clip(out, 0, 255).astype(xp.uint8)


def idct_plane(coeff_blocks, bh: int, bw: int, xp=np):
    """(..., bh*bw, 64) coefficients -> (..., bh*8, bw*8) uint8 plane."""
    lead = coeff_blocks.shape[:-2]
    px = islow_idct(coeff_blocks, xp)  # (..., bh*bw, 8, 8)
    g = px.reshape(lead + (bh, bw, 8, 8))
    perm = tuple(range(len(lead))) + tuple(
        len(lead) + k for k in (0, 2, 1, 3)
    )
    return g.transpose(perm).reshape(lead + (bh * 8, bw * 8))


def _tri_axis_pairs(x, axis, xp):
    """3*near + far along `axis`, interleaved 2x (JFIF-centered, edges
    clamped): out[2i] pairs (i, i-1), out[2i+1] pairs (i, i+1)."""
    n = x.shape[axis]

    def take(lo, hi):
        idx = [slice(None)] * x.ndim
        idx[axis] = slice(lo, hi)
        return x[tuple(idx)]

    prev = xp.concatenate([take(0, 1), take(0, n - 1)], axis=axis)
    nxt = xp.concatenate([take(1, n), take(n - 1, n)], axis=axis)
    even = 3 * x + prev
    odd = 3 * x + nxt
    # interleave along axis: stack a new minor axis then fold
    st = xp.stack([even, odd], axis=axis + 1 if axis >= 0 else x.ndim + axis + 1)
    shape = list(x.shape)
    shape[axis] = 2 * n
    return st.reshape(shape)


def upsample2x_triangular(c, xp=np):
    """(..., h, w) u8 chroma -> (..., 2h, 2w) u8, stb hv2 semantics."""
    t = _tri_axis_pairs(c.astype(xp.int32), -2, xp)      # vertical, 2h x w
    o = _tri_axis_pairs(t, -1, xp)                       # horizontal
    return ((o + 8) >> 4).astype(xp.uint8)


def ycbcr_to_rgb_fixed(y, cb, cr, xp=np):
    """Full-res u8 planes -> (..., 3) u8 RGB, stb 20-bit fixed point."""

    def fx(v: float) -> int:
        return _f2f(v) << 8

    yf = (y.astype(xp.int32) << 20) + (1 << 19)
    cbi = cb.astype(xp.int32) - 128
    cri = cr.astype(xp.int32) - 128
    r = yf + cri * fx(1.40200)
    # the green cb term is truncated to its top 16 bits before the sum
    # (int & 0xffff0000; -65536 is the same mask in two's complement)
    gcb = (cbi * -fx(0.34414)) & xp.int32(-65536)
    g = yf + cri * -fx(0.71414) + gcb
    b = yf + cbi * fx(1.77200)
    rgb = xp.stack([r >> 20, g >> 20, b >> 20], axis=-1)
    return xp.clip(rgb, 0, 255).astype(xp.uint8)


def decode_rgb_from_planes(y, cb, cr, xp=np):
    """4:2:0 YCbCr planes (Y (..., h, w), chroma (..., ceil(h/2),
    ceil(w/2))) -> (..., h, w, 3) u8 RGB, pixel-identical to the native
    FULL decode (and therefore to stb_image)."""
    h, w = y.shape[-2], y.shape[-1]
    cbu = upsample2x_triangular(cb, xp)[..., :h, :w]
    cru = upsample2x_triangular(cr, xp)[..., :h, :w]
    return ycbcr_to_rgb_fixed(y, cbu, cru, xp)


def decode_planes_from_coeffs(yc, cbc, crc, h: int, w: int, xp=np):
    """Dequantized coefficient blocks -> cropped YCbCr 4:2:0 planes.

    yc: (..., ceil(h/8)*ceil(w/8), 64); cbc/crc likewise for the chroma
    dims (ceil(h/2), ceil(w/2)).  Returns (y, cb, cr) u8 planes."""
    ch, cw = -(-h // 2), -(-w // 2)
    ybh, ybw = -(-h // 8), -(-w // 8)
    cbh, cbw = -(-ch // 8), -(-cw // 8)
    y = idct_plane(yc, ybh, ybw, xp)[..., :h, :w]
    cb = idct_plane(cbc, cbh, cbw, xp)[..., :ch, :cw]
    cr = idct_plane(crc, cbh, cbw, xp)[..., :ch, :cw]
    return y, cb, cr


def decode_rgb_from_coeffs(yc, cbc, crc, h: int, w: int, xp=np):
    """The full device-side decode: coefficients -> RGB (one jittable fn)."""
    y, cb, cr = decode_planes_from_coeffs(yc, cbc, crc, h, w, xp)
    return decode_rgb_from_planes(y, cb, cr, xp)
