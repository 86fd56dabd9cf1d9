"""8x8 forward/inverse DCT kernels.

Two families:

* ``aan_dct`` / ``aan_idct`` — the fixed-point AAN (Arai-Agui-Nakajima)
  butterfly the reference uses (image_processing.c:192-307, 492-603),
  reproduced with *exact* int32 semantics (same constants, same arithmetic
  right shifts, same rounding biases).  This is the bit-exactness kernel:
  compat mode must produce identical integers.  Written against a generic
  array namespace so the same source runs under numpy (host oracle) and
  jax.numpy (device, fully batched over a leading blocks axis).

* ``naive_dct_f64`` / ``naive_idct_f64`` — the O(N^4) textbook float DCT
  (image_processing.c:157-183, 452-480) retained as a correctness oracle
  for kernel tests, exactly as the reference keeps it.

* ``dct_matrix_f32`` — orthonormal DCT-II basis for the high-quality
  path: the batched 8x8 DCT as two 8x8 matmuls, used by the non-compat
  pipeline where bit-exactness against C is not required.

The AAN output convention matches the reference: the result is the 2-D
DCT-II scaled by 8 (an /8 descale with +16/+16384 rounding bias is folded
into the final shifts), which downstream quantization accounts for.
"""

from __future__ import annotations

import numpy as np

# Fixed-point constants (reference image_processing.c:40-46).
_C1 = 1004   # cos(pi/16)  << 10
_S1 = 200    # sin(pi/16)  << 10
_C3 = 851    # cos(3pi/16) << 10
_S3 = 569    # sin(3pi/16) << 10
_R2C6 = 554  # sqrt2*cos(6pi/16) << 10
_R2S6 = 1337 # sqrt2*sin(6pi/16) << 10
_R2 = 181    # sqrt2 << 7


def _aan_butterfly(a, xp):
    """Shared stages 1-3 of the AAN 8-point transform.

    `a` is a length-8 list of int32 arrays (one per input element, arbitrary
    broadcastable batch shape).  Returns the 8 pre-descale node values in
    output-index order semantics: (e0, e4, e2, e6, o7a, o7b, o3, o5) where
    out[0]=e0, out[4]=e4, out[2]=scale(e2), out[6]=scale(e6),
    out[7]=scale(o7a-o7b), out[1]=scale(o7a+o7b), out[3]=scale3(o3),
    out[5]=scale3(o5).  Mirrors image_processing.c:208-249 line for line.
    """
    a0, a1, a2, a3, a4, a5, a6, a7 = a
    # stage 1
    s8 = a7 + a0
    d0 = a0 - a7
    s7 = a1 + a6
    d1 = a1 - a6
    s6 = a2 + a5
    d2 = a2 - a5
    s5 = a3 + a4
    d3 = a3 - a4
    # stage 2 (even part)
    e_x4 = s8 + s5
    e_x8 = s8 - s5
    e_x5 = s7 + s6
    e_x7 = s7 - s6
    # stage 2 (odd part, fixed point)
    t6 = _C1 * (d1 + d2)
    o_x2 = (-_S1 - _C1) * d2 + t6
    o_x1 = (_S1 - _C1) * d1 + t6
    t6b = _C3 * (d0 + d3)
    o_x3 = (-_S3 - _C3) * d3 + t6b
    o_x0 = (_S3 - _C3) * d0 + t6b
    # stage 3
    e0 = e_x4 + e_x5          # -> out[0]
    e4 = e_x4 - e_x5          # -> out[4]
    t5 = _R2C6 * (e_x7 + e_x8)
    e6 = (-_R2S6 - _R2C6) * e_x7 + t5   # -> out[6] (pre-shift)
    e2 = (_R2S6 - _R2C6) * e_x8 + t5    # -> out[2] (pre-shift)
    o5_pre = o_x0 + o_x2       # C's final x5
    o3_pre = o_x0 - o_x2       # C's final x0 -> out[5] path
    o1_pre = o_x3 + o_x1       # C's final x2
    o7_pre = o_x3 - o_x1       # C's final x3 -> out[3] path
    return e0, e4, e2, e6, o1_pre, o5_pre, o7_pre, o3_pre


def aan_dct(blocks, xp=np):
    """Exact int32 AAN forward DCT of the reference (rows then columns).

    blocks: (..., 8, 8) integer array (uint8 pixel values).
    returns: (..., 8, 8) int32, the reference's `dct_block` as integers
    (the C code stores them in doubles but every value is integral).
    """
    x = blocks.astype(xp.int32)
    # ---- row pass (image_processing.c:198-250) --------------------------
    a = [x[..., :, k] for k in range(8)]
    e0, e4, e2, e6, o1, o5, o7, o3 = _aan_butterfly(a, xp)
    rows = [None] * 8
    rows[0] = e0
    rows[4] = e4
    rows[2] = e2 >> 10
    rows[6] = e6 >> 10
    rows[7] = (o1 - o5) >> 10
    rows[1] = (o1 + o5) >> 10
    rows[3] = (o7 * _R2) >> 17
    rows[5] = (o3 * _R2) >> 17
    r = xp.stack(rows, axis=-1)  # (..., 8row, 8col) still row-major
    # ---- column pass (image_processing.c:253-305) -----------------------
    a = [r[..., k, :] for k in range(8)]
    e0, e4, e2, e6, o1, o5, o7, o3 = _aan_butterfly(a, xp)
    out = [None] * 8
    out[0] = (e0 + 16) >> 3
    out[4] = (e4 + 16) >> 3
    out[2] = (e2 + 16384) >> 13
    out[6] = (e6 + 16384) >> 13
    out[7] = (o1 - o5 + 16384) >> 13
    out[1] = (o1 + o5 + 16384) >> 13
    out[3] = ((o7 >> 8) * _R2 + 8192) >> 12
    out[5] = ((o3 >> 8) * _R2 + 8192) >> 12
    return xp.stack(out, axis=-2)


def aan_idct(dct_blocks, xp=np):
    """Exact int32 AAN inverse of the reference (image_processing.c:492-603).

    Note: the reference reuses the *forward* butterfly for the inverse
    (columns then rows) and clamps to [0,255] only on out[0]/out[4]; the
    other outputs are truncated through `(unsigned char)` casts.  We
    reproduce that faithfully — this is the latent decode path retained for
    parity, not a mathematically correct IDCT.
    """
    x = dct_blocks.astype(xp.int32)
    # column pass
    a = [x[..., k, :] for k in range(8)]
    e0, e4, e2, e6, o1, o5, o7, o3 = _aan_butterfly(a, xp)
    cols = [None] * 8
    cols[0] = e0
    cols[4] = e4
    cols[2] = e2 >> 10
    cols[6] = e6 >> 10
    cols[7] = (o1 - o5) >> 10
    cols[1] = (o1 + o5) >> 10
    cols[3] = (o7 * _R2) >> 17
    cols[5] = (o3 * _R2) >> 17
    c = xp.stack(cols, axis=-2)
    # row pass
    a = [c[..., :, k] for k in range(8)]
    e0, e4, e2, e6, o1, o5, o7, o3 = _aan_butterfly(a, xp)
    out = [None] * 8
    out[0] = xp.clip(e0, 0, 255)
    out[4] = xp.clip(e4, 0, 255)
    out[2] = (e2 >> 10) & 0xFF
    out[6] = (e6 >> 10) & 0xFF
    out[7] = ((o1 - o5) >> 10) & 0xFF
    out[1] = ((o1 + o5) >> 10) & 0xFF
    out[3] = ((o7 * _R2) >> 17) & 0xFF
    out[5] = ((o3 * _R2) >> 17) & 0xFF
    return xp.stack(out, axis=-1).astype(xp.uint8)


def naive_dct_f64(block: np.ndarray) -> np.ndarray:
    """O(N^4) orthonormal float DCT-II oracle (image_processing.c:157-183).

    Output layout matches the reference: dct[v, u] indexed by (vertical
    freq, horizontal freq) of input block[y, x], i.e. the plain separable
    2-D DCT of the (row, col)-indexed block.  Unscaled (no *8).
    """
    n = 8
    y = np.arange(n)
    basis = np.cos((2 * y[:, None] + 1) * np.arange(n)[None, :] * np.pi / (2 * n))
    cu = np.where(np.arange(n) == 0, np.sqrt(1 / n), np.sqrt(2 / n))
    b = block.reshape(8, 8).astype(np.float64)
    # sum over x,y of pix[y,x] cos((2x+1)u) cos((2y+1)v) * cu cv
    return (cu[:, None] * cu[None, :]) * (basis.T @ b @ basis)


def naive_idct_f64(dct_block: np.ndarray) -> np.ndarray:
    """Inverse of naive_dct_f64 with the reference's round+clamp to uint8."""
    n = 8
    y = np.arange(n)
    basis = np.cos((2 * y[:, None] + 1) * np.arange(n)[None, :] * np.pi / (2 * n))
    cu = np.where(np.arange(n) == 0, np.sqrt(1 / n), np.sqrt(2 / n))
    d = (cu[:, None] * cu[None, :]) * dct_block.reshape(8, 8).astype(np.float64)
    pix = basis @ d @ basis.T
    return np.clip(np.round(pix), 0, 255).astype(np.uint8)


def matmul_dct(blocks, xp=np):
    """Batched 8x8 DCT as two matmuls: (..., 8, 8) u8 -> i32.

    Uses the orthonormal basis (same scale convention as `aan_dct` but
    ~2000x more accurate: f32 error ~1e-3 vs the AAN fixed point's +-2-3).
    The correct-mode encoder uses this at high quality where the AAN
    truncation noise caps PSNR around 40 dB; not usable in compat mode
    (bit-exactness requires the reference's integer arithmetic).

    Determinism: the einsum runs at Precision.HIGHEST, so the GPU does
    not compute the f32 product in TF32 (nor any backend through bf16).
    Host numpy, XLA CPU, and every CPU-mesh sharding produce
    byte-identical streams (tests/test_sharding.py q=85 row); across
    hardware backends f32 contraction-order differences can still flip a
    rounding on rare half-ulp ties, so cross-hardware encodes promise
    equal PSNR (to 0.05 dB) rather than equal bytes.  The integer
    `aan_dct` path is bit-deterministic everywhere and is the default
    below quality 70.
    """
    d = xp.asarray(dct_matrix_f32())
    b = blocks.astype(xp.float32)
    if xp is np:
        f = xp.einsum("vy,...yx,ux->...vu", d, b, d)
    else:
        f = xp.einsum("vy,...yx,ux->...vu", d, b, d, precision="highest")
    # round-half-away from zero, then int32 (jnp.round is half-to-even;
    # either is fine for quality, but keep host/device identical)
    return xp.where(f >= 0, xp.floor(f + 0.5), xp.ceil(f - 0.5)).astype(xp.int32)


def dct_matrix_f32() -> np.ndarray:
    """Orthonormal 8-point DCT-II matrix D (f32): coeffs = D @ block @ D.T.

    The high-quality (non-compat) path computes batched DCTs as two
    matmuls.
    The AAN fixed-point kernel approximates this same orthonormal scale
    (its /8 descale is folded into the final shift constants), so both
    paths feed the same quantizer convention.
    """
    n = 8
    k = np.arange(n)
    d = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / (2 * n))
    d *= np.where(k[:, None] == 0, np.sqrt(1 / n), np.sqrt(2 / n))
    return d.astype(np.float32)
