"""Batched device encoder pipelines.

`compat_pipeline` maps a batch of YCbCr frames to per-slice packed byte
segments entirely with array ops: blockize -> int32 AAN DCT -> quantize ->
zigzag -> vectorized VLC -> prefix-sum bit packing.  Under jax.numpy the
whole thing jits into one XLA program per batch; under numpy it doubles
as a host oracle.  Byte-exact against models/oracle.py and therefore
against the reference encoder.

Frame geometry (compat): the reference encodes a hard 96-column x 144-row
crop as 6 column-band "slices" x 9 MBs (encoder.h:238,248) and reads
chroma from the full-res planes at half stride (Q3) — which is exactly a
contiguous 8x8 tile of the plane viewed with shape (2H, W/2).
"""

from __future__ import annotations

import functools

import numpy as np

from ec504_imageencoder_tpu.ops.bitpack import pack_bytes
from ec504_imageencoder_tpu.ops.color import rgb_to_ycbcr_exact
from ec504_imageencoder_tpu.ops.dct import aan_dct
from ec504_imageencoder_tpu.ops.quant import quantize
from ec504_imageencoder_tpu.ops.vlc_device import block_streams_compat
from ec504_imageencoder_tpu.ops.zigzag import zigzag_scan
from ec504_imageencoder_tpu.syntax import headers
from ec504_imageencoder_tpu.utils.tables import scale_quantization_matrix

CROP_W = 96
CROP_H = 144
N_SLICES = CROP_W // 16   # 6 column bands (the reference's "slices")
N_MBS = CROP_H // 16      # 9 macroblocks per slice
QUANT_SCALE = 1

# worst-case compat slice: 38 hdr bits + 9 MBs * (2 + 6 blocks * (15 DC +
# 63*28 AC + 2 EOB)) bits = 12,026 B, rounded up to a 512-byte multiple
MAX_SLICE_BYTES_COMPAT = 12288

# luma-block gather indices within the cropped block grid (numpy consts
# baked into the jitted program)
_B_IDX = np.arange(4)
_LUMA_ROW = (2 * np.arange(N_MBS)[None, :, None] + _B_IDX[None, None, :] // 2)
_LUMA_ROW = np.broadcast_to(_LUMA_ROW, (N_SLICES, N_MBS, 4))
_LUMA_COL = (2 * np.arange(N_SLICES)[:, None, None] + _B_IDX[None, None, :] % 2)
_LUMA_COL = np.broadcast_to(_LUMA_COL, (N_SLICES, N_MBS, 4))
_IS_LUMA = np.array([1, 1, 1, 1, 0, 0], np.int32)  # block order within a MB


def _blockize(plane, xp):
    """(..., H, W) -> (..., H/8, W/8, 8, 8)."""
    h, w = plane.shape[-2], plane.shape[-1]
    lead = plane.shape[:-2]
    p = plane.reshape(lead + (h // 8, 8, w // 8, 8))
    perm = tuple(range(len(lead))) + tuple(
        len(lead) + k for k in (0, 2, 1, 3)
    )
    return p.transpose(perm)


def compat_pipeline(y, cb, cr, scaled_q, max_slice_bytes=MAX_SLICE_BYTES_COMPAT, xp=np):
    """(B,H,W) u8 planes -> ((B, 6, max_slice_bytes) u8, (B, 6) i32 bit lens).

    Slices are byte-aligned islands; callers take ceil(nbits/8) bytes of
    each (zero padding is already in place).
    """
    bsz, h, w = y.shape

    luma_grid = _blockize(y[:, :CROP_H, :CROP_W], xp)        # (B,18,12,8,8)
    luma = luma_grid[:, xp.asarray(_LUMA_ROW), xp.asarray(_LUMA_COL)]  # (B,6,9,4,8,8)

    # chroma quirk Q3: full-res plane, half-width stride == (2H, W/2) view
    def chroma_blocks(p):
        # the reference reads the full-res plane with half-width stride
        # (pointer math, Q3): element (r, c) = flat[r*(w//2) + c].  A
        # (2h, w//2) reshape is only equivalent for even widths; the
        # flat view below matches C for any width.
        half = w // 2
        flat = p.reshape(bsz, h * w)
        v = flat[:, : 8 * N_MBS * half].reshape(bsz, 8 * N_MBS, half)
        v = v[:, :, : 8 * N_SLICES]
        g = _blockize(v, xp)                                  # (B,9,6,8,8)
        return g.transpose(0, 2, 1, 3, 4)                     # (B,6,9,8,8)

    cbb = chroma_blocks(cb)[:, :, :, None]
    crb = chroma_blocks(cr)[:, :, :, None]
    blocks = xp.concatenate([luma, cbb, crb], axis=3)         # (B,6,9,6,8,8)

    coeffs = aan_dct(blocks, xp)
    qcoef = quantize(coeffs, xp.asarray(scaled_q), xp)
    zz = zigzag_scan(qcoef, xp)                               # (B,6,9,6,64)

    is_luma = xp.broadcast_to(xp.asarray(_IS_LUMA), zz.shape[:-1])
    codes, lens = block_streams_compat(zz, is_luma, xp)       # (B,6,9,6,65)

    # --- slice assembly as one flat code stream ---------------------------
    mb_code = xp.full((bsz, N_SLICES, N_MBS, 1), 0b11, dtype=xp.uint32)
    mb_len = xp.full((bsz, N_SLICES, N_MBS, 1), 2, dtype=xp.int32)
    per_mb_codes = xp.concatenate(
        [mb_code, codes.reshape(bsz, N_SLICES, N_MBS, -1)], axis=-1
    )
    per_mb_lens = xp.concatenate(
        [mb_len, lens.reshape(bsz, N_SLICES, N_MBS, -1)], axis=-1
    )

    # slice header: 24-bit start + vpos byte fused to one 32-bit slot, then
    # 5-bit qscale + 1 stop bit as a 6-bit slot (mpeg1_blk.c:12-18)
    vpos = xp.arange(1, N_SLICES + 1, dtype=xp.uint32)
    hdr_a = xp.broadcast_to((xp.uint32(0x100) | vpos)[None, :, None], (bsz, N_SLICES, 1))
    hdr_a_len = xp.full((bsz, N_SLICES, 1), 32, dtype=xp.int32)
    hdr_b = xp.full((bsz, N_SLICES, 1), (QUANT_SCALE & 0x1F) << 1, dtype=xp.uint32)
    hdr_b_len = xp.full((bsz, N_SLICES, 1), 6, dtype=xp.int32)

    slice_codes = xp.concatenate(
        [hdr_a, hdr_b, per_mb_codes.reshape(bsz, N_SLICES, -1)], axis=-1
    )
    slice_lens = xp.concatenate(
        [hdr_a_len, hdr_b_len, per_mb_lens.reshape(bsz, N_SLICES, -1)], axis=-1
    )
    return pack_bytes(slice_codes, slice_lens, max_slice_bytes, xp=xp)


@functools.lru_cache(maxsize=8)
def _jitted_compat_pipeline(max_slice_bytes: int):
    import jax
    import jax.numpy as jnp

    def fn(y, cb, cr, scaled_q):
        return compat_pipeline(
            y, cb, cr, scaled_q, max_slice_bytes=max_slice_bytes, xp=jnp
        )

    return jax.jit(fn)


def _validate_frames(frames: np.ndarray) -> None:
    if frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(
            f"expected (B, H, W, 3) uint8 RGB frames, got {frames.shape}"
        )
    if frames.shape[1] < CROP_H or frames.shape[2] < CROP_W:
        raise ValueError(
            f"compat mode encodes a {CROP_W}x{CROP_H} region; frames of "
            f"{frames.shape[2]}x{frames.shape[1]} are too small"
        )
    if frames.dtype != np.uint8:
        raise ValueError(f"expected uint8 frames, got {frames.dtype}")


def encode_compat(
    frames_rgb,
    quality: int = 12,
    backend: str = "jax",
    batch_size: int | None = None,
) -> tuple[bytes, list[bytes]]:
    """Compat-mode encode: RGB frames -> (mpeg bytes, per-frame .bit dumps).

    Drop-in equivalent of the reference's mpeg_encode_procedure
    (encoder.h:20) minus file I/O; byte-exact against it.  `backend="jax"`
    runs the block pipeline on the default JAX device; "numpy" runs the
    same code on host.
    """
    frames = np.ascontiguousarray(frames_rgb)
    _validate_frames(frames)
    bsz, h, w = frames.shape[:3]

    # exact C-double colorspace (host; the one non-integer compat stage)
    y, cb, cr = rgb_to_ycbcr_exact(frames)
    scaled_q = scale_quantization_matrix(quality)

    if backend == "jax":
        fn = _jitted_compat_pipeline(MAX_SLICE_BYTES_COMPAT)
        seg_bytes_dev, seg_bits_dev = fn(y, cb, cr, scaled_q)
        # two-step fetch: bit lengths first (tiny), then only the used byte
        # prefix, bucketed to limit recompiles — host<->device bandwidth is
        # the scarce resource, not device compute
        seg_bits = np.asarray(seg_bits_dev)
        used = int(seg_bits.max(initial=0) + 7) // 8
        bucket = max(256, 1 << (used - 1).bit_length())
        bucket = min(bucket, MAX_SLICE_BYTES_COMPAT)
        seg_bytes = np.asarray(seg_bytes_dev[:, :, :bucket])
    elif backend == "numpy":
        seg_bytes, seg_bits = compat_pipeline(y, cb, cr, scaled_q, xp=np)
    else:
        raise ValueError(f"unknown backend {backend!r}")

    out = bytearray()
    out += headers.pack_header(2202035)
    out += headers.system_header(2202035, 0xE6)
    dumps = []
    for i in range(bsz):
        frame = bytearray()
        frame += headers.pes_packet_header(1 + 3600 * i)
        frame += headers.sequence_header(w & 0xFF, h & 0xFF)
        frame += headers.gop_header(hour=i, minute=0, second=0)
        frame += headers.picture_header(temporal_ref=0)
        for s in range(N_SLICES):
            nb = (int(seg_bits[i, s]) + 7) // 8
            frame += bytes(seg_bytes[i, s, :nb])
        headers.patch_pes_length(frame)
        frame += headers.COMPAT_SEQUENCE_END_GARBAGE
        out += frame
        dumps.append(
            headers.raw_plane_dump(w, h, y[i].reshape(-1), cb[i].reshape(-1), cr[i].reshape(-1))
        )
    return bytes(out), dumps
