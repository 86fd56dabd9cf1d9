"""Colorspace conversion and 4:2:0 chroma subsampling.

Reference behavior: image_processing.c:68-110 (BT.601 full-range RGB ->
YCbCr in C doubles with (unsigned char) truncation) and :114-133 (2x2 box
average with C integer division).

Bit-exactness note: the compat path must reproduce C double arithmetic.
IEEE-754 f64 elementwise numpy ops with the same association order are
identical to the C expression, so `rgb_to_ycbcr_exact` is the compat
kernel (host-side, verified against the reference's .bit plane dumps).
The device fast path uses f32 (`rgb_to_ycbcr` with xp=jnp), which can
differ from C by 1 ulp on near-integer sums — fine for correct mode,
not used in compat mode.
"""

from __future__ import annotations

import numpy as np


def rgb_to_ycbcr_exact(rgb: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(H, W, 3) uint8 -> three (H, W) uint8 planes, C-double-exact."""
    r = rgb[..., 0].astype(np.float64)
    g = rgb[..., 1].astype(np.float64)
    b = rgb[..., 2].astype(np.float64)
    y = (0.299 * r + 0.587 * g + 0.114 * b).astype(np.uint8)
    cb = (128 - 0.168736 * r - 0.331264 * g + 0.5 * b).astype(np.uint8)
    cr = (128 + 0.5 * r - 0.418688 * g - 0.081312 * b).astype(np.uint8)
    return y, cb, cr


def _ycbcr_full_i32(r, g, b, xp):
    half = 1 << 15
    y = (19595 * r + 38470 * g + 7471 * b + half) >> 16
    cb = ((-11059 * r - 21709 * g + 32768 * b + half) >> 16) + 128
    cr = ((32768 * r - 27439 * g - 5329 * b + half) >> 16) + 128
    u8 = lambda v: xp.clip(v, 0, 255).astype(xp.uint8)
    return u8(y), u8(cb), u8(cr)


def _ycbcr_studio_i32(r, g, b, xp):
    half = 1 << 15
    # 65536 * 219/255 * (0.299, 0.587, 0.114) and 224/255 * Cb/Cr rows
    y = ((16830 * r + 33039 * g + 6417 * b + half) >> 16) + 16
    cb = ((-9715 * r - 19070 * g + 28784 * b + half) >> 16) + 128
    cr = ((28784 * r - 24103 * g - 4681 * b + half) >> 16) + 128
    u8 = lambda v: xp.clip(v, 0, 255).astype(xp.uint8)
    return u8(y), u8(cb), u8(cr)


def pack_rgbx_u32(rgb, xp):
    """(..., 3) u8 interleaved RGB -> (...,) u32 0x00BBGGRR (little-endian).

    One zero-pad + bitcast converts the interleaved (..., 3) u8 image to
    a clean rank-3 u32 array; channel extraction becomes shifts/masks.
    jnp-only (numpy callers keep the sliced path)."""
    import jax

    z = xp.zeros(rgb.shape[:-1] + (1,), xp.uint8)
    return jax.lax.bitcast_convert_type(
        xp.concatenate([rgb, z], axis=-1), xp.uint32
    )


def rgb_to_ycbcr_packed(pix, xp, color_range: str = "studio"):
    """Packed-u32 variant of rgb_to_ycbcr[_studio]; bit-identical output."""
    r = (pix & 0xFF).astype(xp.int32)
    g = ((pix >> 8) & 0xFF).astype(xp.int32)
    b = ((pix >> 16) & 0xFF).astype(xp.int32)
    fn = _ycbcr_studio_i32 if color_range == "studio" else _ycbcr_full_i32
    return fn(r, g, b, xp)


def rgb_to_ycbcr(rgb, xp=np):
    """Device colorspace kernel: 16-bit fixed point BT.601 full range.

    Integer arithmetic is bit-identical on every backend — f32 here is
    NOT (XLA fuses multiply-adds, numpy doesn't; the 1-ulp differences
    flip rounded pixels and change downstream VLC lengths).  Rounding is
    +0.5 via the 1<<15 bias; results clipped to u8.
    (..., H, W, 3) u8 -> three (..., H, W) u8 planes.
    """
    i = rgb.astype(xp.int32)
    return _ycbcr_full_i32(i[..., 0], i[..., 1], i[..., 2], xp)


def rgb_to_ycbcr_studio(rgb, xp=np):
    """Device colorspace kernel: BT.601 *studio range* (Y 16-235, C 16-240).

    MPEG-1 carries no range signaling and standard decoders (FFmpeg, and
    the reference's suggested players, README.md:140) assume limited
    range; the reference encoder's full-range JPEG-style conversion
    (image_processing.c:104-106) is why its output renders with stretched
    contrast.  Same 16-bit fixed-point scheme as rgb_to_ycbcr so results
    are bit-identical across backends.
    (..., H, W, 3) u8 -> three (..., H, W) u8 planes.
    """
    i = rgb.astype(xp.int32)
    return _ycbcr_studio_i32(i[..., 0], i[..., 1], i[..., 2], xp)


def subsample_420(plane, xp=np):
    """2x2 box average, C integer division (image_processing.c:114-133).

    (..., H, W) u8 -> (..., H//2, W//2) u8.  Sum of four u8 fits in u16;
    //4 on non-negative ints == C truncating division.

    numpy path: reshape + paired sums.  jnp path: `lax.reduce_window`
    (XLA's pooling lowering).  Both paths are value-identical
    (fuzz-locked).
    """
    h, w = plane.shape[-2], plane.shape[-1]
    p = plane[..., : h - h % 2, : w - w % 2].astype(xp.int32)
    if xp is not np:
        import jax

        win = (1,) * (p.ndim - 2) + (2, 2)
        s = jax.lax.reduce_window(p, 0, jax.lax.add, win, win, "VALID")
        return (s >> 2).astype(xp.uint8)
    batch = p.shape[:-2]
    rows = p.reshape(batch + (h // 2, 2, w - w % 2)).sum(axis=-2)
    s = rows.reshape(batch + (h // 2, w // 2, 2)).sum(axis=-1)
    return (s >> 2).astype(xp.uint8)  # /4 as shift (XLA int div is costly)


def upsample_420(plane, xp=np):
    """Nearest-neighbour 2x replication (image_processing.c:607-638)."""
    return xp.repeat(xp.repeat(plane, 2, axis=-2), 2, axis=-1)


def ycbcr_to_rgb_f32(y, cb, cr, xp=np, color_range: str = "full"):
    """BT.601 inverse for the verification decoder (image_processing.c:678-686
    constants; implemented correctly — the reference's own function reads
    Y/Cb/Cr all from the same buffer by mistake and is never called).

    color_range="studio" inverts rgb_to_ycbcr_studio (16-235/16-240)."""
    if color_range not in ("studio", "full"):
        raise ValueError(
            f"color_range must be 'studio' or 'full', got {color_range!r}"
        )
    yf = y.astype(xp.float32)
    cbf = cb.astype(xp.float32) - 128.0
    crf = cr.astype(xp.float32) - 128.0
    if color_range == "studio":
        yf = (yf - 16.0) * (255.0 / 219.0)
        cbf = cbf * (255.0 / 224.0)
        crf = crf * (255.0 / 224.0)
    r = yf + 1.402 * crf
    g = yf - 0.344136 * cbf - 0.714136 * crf
    b = yf + 1.772 * cbf
    u8 = lambda v: xp.clip(v, 0.0, 255.0).astype(xp.uint8)
    return xp.stack([u8(r), u8(g), u8(b)], axis=-1)
