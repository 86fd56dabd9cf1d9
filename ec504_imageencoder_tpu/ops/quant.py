"""Quantization / dequantization of DCT coefficients.

Reference: image_processing.c:349-370 — `(int)(round(dct)/q)` where the
DCT values are integral doubles, so the operation is exactly C truncating
integer division (proof: |r/q| >= 1/255 >> half-ulp of any representable
quotient, so the double division can never round across an integer).
"""

from __future__ import annotations

import numpy as np


def quantize(dct_int, scaled_q, xp=np):
    """Truncating division toward zero: (..., 8, 8) i32 / (8, 8) i32.

    On device this runs as f32 division + floor + integer correction
    (exact_div_floor) instead of an int32 divide.  A device f32 division
    need not be correctly rounded, so the f32 quotient can be off by a
    few ulp.  For our magnitudes (|coeff| <= ~2100, q <= 4150) that error
    is < 1, so a branchless +-1 fix-up with exact int32 multiplies
    recovers the true floor.  Locked by a fuzz test against the integer
    path.
    """
    d = dct_int.astype(xp.int32)
    if xp is np:
        q = scaled_q.astype(np.int32)
        return np.sign(d) * (np.abs(d) // q)
    a = xp.abs(d)
    q = scaled_q.astype(xp.int32)
    mag = exact_div_floor(a, q, xp)
    return xp.sign(d) * mag


def exact_div_floor(a, q, xp):
    """floor(a / q) for non-negative int32 a and positive int32 q, using f32
    division with a +-1 integer correction (valid while a < 2**23 and the
    approximate quotient error is < 1, i.e. any sane hardware divide)."""
    k0 = xp.floor(a.astype(xp.float32) / q.astype(xp.float32)).astype(xp.int32)
    k0 = xp.maximum(k0, 0)
    too_big = (k0 * q > a).astype(xp.int32)
    too_small = ((k0 + 1) * q <= a).astype(xp.int32)
    return k0 - too_big + too_small


def dequantize(quantized, q_matrix, xp=np):
    """Reconstruction multiply (image_processing.c:438-446; reference uses the
    *unscaled* base matrix — kept for its latent decode path, while the
    correct decoder passes the scaled matrix)."""
    return quantized.astype(xp.int32) * q_matrix.astype(xp.int32)
