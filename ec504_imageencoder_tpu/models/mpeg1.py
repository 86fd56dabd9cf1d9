"""Correct-mode MPEG-1 intra encoder: ISO 11172-2-compliant, any resolution.

This is the flagship production path.  Where compat mode reproduces the
reference's bug surface (SURVEY.md §2.9), this encoder fixes all of it:

  * real 12-bit dimensions, frames padded to macroblock multiples (Q1/Q2)
  * chroma encoded from the actual 4:2:0 subsampled planes (Q3)
  * signed AC coefficients, ISO run/level table indexing (Q4, table bug)
  * no run-0 truncation — every coefficient is coded (Q5)
  * differential DC prediction with per-slice reset (Q6)
  * one slice per macroblock row, proper GOP/timecode/temporal_ref (Q10)
  * real sequence_end_code (Q8)

Output is a clean MPEG-1 *video elementary stream* playable by standard
decoders; system-layer muxing (pack/PES) is available separately via
syntax.headers for parity with the reference's container.

The whole per-frame pipeline — RGB->YCbCr, 4:2:0, blockize, integer AAN
DCT, ISO intra quantization, zigzag, differential DC, vectorized VLC,
prefix-sum bit packing — is one jitted XLA program; slices (macroblock
rows) are independent bitstream islands, which is what makes both the
MB-row sharding axis and the frame sharding axis embarrassingly parallel
(parallel/ wires those through jax.sharding).
"""

from __future__ import annotations

import functools
import os

import numpy as np

from ec504_imageencoder_tpu.ops.bitpack import pack_bytes
from ec504_imageencoder_tpu.ops.color import (
    rgb_to_ycbcr,
    rgb_to_ycbcr_studio,
    subsample_420,
)
from ec504_imageencoder_tpu.ops.dct import aan_dct, matmul_dct
from ec504_imageencoder_tpu.ops.quant import exact_div_floor
from ec504_imageencoder_tpu.ops.vlc_device import block_streams_correct64
from ec504_imageencoder_tpu.ops.zigzag import zigzag_scan
from ec504_imageencoder_tpu.syntax import headers
from ec504_imageencoder_tpu.syntax.bitwriter import BitWriter
from ec504_imageencoder_tpu.utils.tables import (
    INTRA_Q_MATRIX,
    ZIGZAG_GATHER,
    scale_quantization_matrix,
)

FRAME_RATE_CODES = {
    23.976: 1, 24.0: 2, 25.0: 3, 29.97: 4, 30.0: 5, 50.0: 6, 59.94: 7, 60.0: 8,
}
FRAME_RATE_VALUES = {v: k for k, v in FRAME_RATE_CODES.items()}


# 12-bit sequence-header fields (ISO 11172-2 §2.4.2.3) bound width and
# height at 4095; the slice-start-code range 0x01..0xAF further bounds
# height at 175 macroblock rows in our one-slice-per-row scheme.
MAX_WIDTH = 4095
MAX_HEIGHT = 175 * 16  # 2800


def quality_to_quant(quality: int) -> tuple[np.ndarray, int]:
    """Map JPEG-style quality in [1,100] to (intra matrix u8, quant_scale).

    The JPEG-style scaled matrix (reference semantics) becomes the custom
    intra quantizer matrix, with quantizer_scale absorbing any factor that
    exceeds the 8-bit matrix entry range.  Reconstruction divisor is
    quant_scale * W / 8, so quant_scale == 8 with W == M reproduces the
    same step sizes as compat mode.

    Saturation at extreme low quality: both carriers are hard-capped by
    the bitstream format — quant_scale at 31 (5-bit field) and matrix
    entries at 255 (8-bit), so the largest representable step size is
    31*255/8 ≈ 988.  The JPEG mapping (5000/qf scaling,
    image_processing.c:327-341) first exceeds that cap below quality 5:
    at quality <= 4 the largest steps silently clamp to the ~988 ceiling
    (58 of 64 entries saturated at quality 1) instead of the ever coarser
    steps the JPEG formula implies.  Quality >= 5 tracks the JPEG mapping
    to within 0.3% per entry.  Locked by a test.
    """
    m = scale_quantization_matrix(quality).astype(np.int64)
    s = max(1, int(np.ceil(m.max() / 255.0)))
    qscale = int(np.clip(8 * s, 1, 31))
    w = np.clip(np.round(8.0 * m / qscale), 1, 255).astype(np.int32)
    return w, qscale


def slice_bytes_bucket(nbytes: int) -> int:
    """Round a slice-buffer size up to a 512-byte multiple, >= 2560.

    The rounding bounds recompiles: the buffer size is a jit key, so a
    regrow lands on one of few bucketed sizes instead of a new program
    per exact byte count."""
    return max(2560, -(-nbytes // 512) * 512)


def worst_case_slice_bytes(mbw: int) -> int:
    """Hard upper bound on one slice's bytes, from the bitstream format.

    Per 8x8 block: DC size code (<= 8 bits) + <= 8 DC bits, 63 AC
    escapes at 6+6+16 = 28 bits (levels are clamped to the 8/16-bit
    escape range), 2-bit EOB; per MB: 2-bit header + 6 blocks; per
    slice: 38 header bits + mbw MBs.  The reference's growable
    bitvector (bit_vector.c:148-169) never needs this bound because it
    reallocs; a fixed-size device buffer sized here can never overflow."""
    per_block = 8 + 8 + 63 * 28 + 2
    bits = 38 + mbw * (2 + 6 * per_block)
    return slice_bytes_bucket(-(-bits // 8))


def initial_slice_bytes(quality: int, mbw: int) -> int:
    """Default slice-buffer size for (quality, frame width).

    Sized from measured content (1080p white noise at q=50 packs ~183
    bits/block; real images far less) with headroom, NOT the worst case:
    the pack kernel writes the whole buffer, so a worst-case default
    would multiply the pack stage's HBM traffic ~8x for nothing.
    Adversarial content that overflows triggers one exact regrow +
    re-encode (MPEG1IntraEncoder._run_pipeline)."""
    if quality <= 60:
        per_block = 256
    elif quality <= 85:
        per_block = 384
    else:
        per_block = 512
    bits = 38 + mbw * 6 * per_block
    return min(slice_bytes_bucket(-(-bits // 8)), worst_case_slice_bytes(mbw))


def pad_to_macroblocks(frames: np.ndarray) -> np.ndarray:
    """Edge-replicate (B, H, W, 3) frames to multiples of 16."""
    h, w = frames.shape[1:3]
    ph, pw = -h % 16, -w % 16
    if ph or pw:
        frames = np.pad(frames, ((0, 0), (0, ph), (0, pw), (0, 0)), mode="edge")
    return frames


def _emit_and_pack(zz, pred, max_slice_bytes, xp):
    """VLC emission + pack: 64-slot layout, header bit offset."""
    bsz, mbh, mbw = zz.shape[0], zz.shape[1], zz.shape[2]
    is_luma = xp.broadcast_to(
        xp.asarray(np.array([1, 1, 1, 1, 0, 0], np.int32)), zz.shape[:-1]
    )
    # 2-bit MB header '11' folds into the first block's DC slot
    mb_first = xp.broadcast_to(
        xp.asarray(np.array([1, 0, 0, 0, 0, 0], np.int32)), zz.shape[:-1]
    )
    codes, lens = block_streams_correct64(zz, pred, is_luma, xp,
                                          mb_first=mb_first)
    # 64 slots per block, EOB and MB codes folded in -> the slot stream
    # is a pure contiguous reshape; the 38-bit slice header (start code
    # + vpos + qscale) rides as a pack offset and is ORed into the
    # first 5 bytes by the caller.  No concatenates anywhere.
    slice_codes = codes.reshape(bsz, mbh, mbw * 6 * 64)
    slice_lens = lens.reshape(bsz, mbh, mbw * 6 * 64)
    seg, nbits = pack_bytes(
        slice_codes, slice_lens, max_slice_bytes, xp=xp, bit_offset=38
    )
    if xp is not np and os.environ.get("EC504_DEBUG_CHECKS", "0") == "1":
        # read at trace time; a violation surfaces as a negated slice bit
        # count, which MPEG1IntraEncoder._run_with_regrow raises on
        viol = slot_violations(slice_codes, slice_lens, xp)
        nbits = xp.where(viol > 0, -viol, nbits)
    return seg, nbits


def slot_violations(codes, lens, xp):
    """Per-slice count of slots that break the pack's input contract:
    a length outside [0, 30], or code bits set above the length."""
    bad_len = (lens < 0) | (lens > 30)
    mask = (xp.uint32(1) << xp.clip(lens, 0, 31).astype(xp.uint32)
            ) - xp.uint32(1)
    bad_code = (codes.astype(xp.uint32) & ~mask) != xp.uint32(0)
    return xp.sum((bad_len | bad_code).astype(xp.int32), axis=-1)


def _dc_predictors(dc, bsz, mbh, mbw, xp):
    """Shifted previous same-component DC, 128 at slice start.

    dc: (B, mbh, mbw, 6) -> pred of the same shape."""
    p128 = xp.full((bsz, mbh, 1), 128, dtype=dc.dtype)
    luma_dc = dc[..., :4].reshape(bsz, mbh, mbw * 4)
    luma_pred = xp.concatenate([p128, luma_dc[..., :-1]], axis=-1)
    luma_pred = luma_pred.reshape(bsz, mbh, mbw, 4)
    cb_pred = xp.concatenate([p128, dc[..., :-1, 4]], axis=-1)[..., None]
    cr_pred = xp.concatenate([p128, dc[..., :-1, 5]], axis=-1)[..., None]
    return xp.concatenate([luma_pred, cb_pred, cr_pred], axis=-1)


def correct_pipeline_planes(
    y, cb, cr, intra_q, qscale, max_slice_bytes, xp=np, dct_impl="aan",
):
    """YCbCr 4:2:0 planes intake: y (B, H, W) u8 (H, W multiples of 16),
    cb/cr (B, H/2, W/2) u8 -> (slice segments, bit lens).

    blockize -> DCT -> quantize -> zigzag -> 64-slot VLC emission ->
    prefix-sum pack.  The same code runs under numpy (host oracle) and
    under jnp (the jitted device program).

    The JPEG-source fast path: JPEGs already carry full-range BT.601
    4:2:0 YCbCr, so decoding to RGB and re-converting
    (decode IDCT->upsample->color, encode color->subsample) is four
    stages of pure rounding loss.  Feeding the decoded planes straight
    in (io/jpeg.decode_planes_batch) skips all four, halves the
    host->device bytes vs RGB, and is higher-fidelity.
    """
    bsz, h, w = y.shape
    mbh, mbw = h // 16, w // 16

    def blockgrid(p):
        hh, ww = p.shape[-2], p.shape[-1]
        g = p.reshape(bsz, hh // 8, 8, ww // 8, 8)
        return g.transpose(0, 1, 3, 2, 4)  # (B, rows8, cols8, 8, 8)

    # pure reshape/transpose, no gather: luma MB order [TL, TR, BL, BR]
    lg = y.reshape(bsz, mbh, 2, 8, mbw, 2, 8)
    luma = lg.transpose(0, 1, 4, 2, 5, 3, 6).reshape(bsz, mbh, mbw, 4, 8, 8)
    cbb = blockgrid(cb)[:, :, :, None]                 # (B,mbh,mbw,1,8,8)
    crb = blockgrid(cr)[:, :, :, None]
    blocks = xp.concatenate([luma, cbb, crb], axis=3)  # (B,mbh,mbw,6,8,8)

    f = aan_dct(blocks, xp) if dct_impl == "aan" else matmul_dct(blocks, xp)

    # ISO intra quantization: DC step 8 (rounded); AC level =
    # round-half-up(8*F / (qscale*W)), clamped to the escape range.
    dc = xp.clip((f[..., 0, 0] + 4) >> 3, 0, 255)      # (B,mbh,mbw,6)
    qw = (intra_q * qscale).astype(xp.int32)           # (8,8)
    num = 16 * xp.abs(f) + qw
    mag = exact_div_floor(num, 2 * qw, xp) if xp is not np else (num // (2 * qw))
    lvl = xp.sign(f) * xp.clip(mag, 0, 255)
    zzq = zigzag_scan(lvl, xp)
    # lane-aligned DC substitution (a concatenate would force a 1+63
    # relayout copy of the whole coefficient tensor)
    lane = xp.arange(64, dtype=xp.int32)
    zz = xp.where(lane == 0, dc[..., None], zzq)

    pred = _dc_predictors(dc, bsz, mbh, mbw, xp)
    seg, nbits = _emit_and_pack(zz, pred, max_slice_bytes, xp)
    return _or_slice_headers(seg, nbits, bsz, mbh, qscale, xp)


def _or_slice_headers(seg, nbits, bsz, mbh, qscale, xp):
    vpos = xp.arange(1, mbh + 1, dtype=xp.uint8)
    hdr = xp.stack(
        [
            xp.zeros((mbh,), xp.uint8),
            xp.zeros((mbh,), xp.uint8),
            xp.ones((mbh,), xp.uint8),
            vpos,
            xp.full((mbh,), (qscale & 0x1F) << 3, xp.uint8),
        ],
        axis=-1,
    )  # (mbh, 5): 00 00 01 vpos [qscale<<1,'0' extra bit]<<2
    hdr = xp.broadcast_to(hdr[None], (bsz, mbh, 5))
    if xp is np:
        seg[..., :5] |= hdr
    else:
        seg = seg.at[..., :5].set(seg[..., :5] | hdr)
    return seg, nbits


def correct_pipeline(
    rgb, intra_q, qscale, max_slice_bytes, xp=np, dct_impl="aan",
    color_range="studio",
):
    """(B, H, W, 3) u8 (H, W multiples of 16) ->
    ((B, mb_h, max_slice_bytes) u8 slice segments, (B, mb_h) i32 bit lens).

    color_range: "studio" (BT.601 16-235/16-240 — what standard MPEG-1
    decoders assume; validated via a third-party decoder) or "full"
    (reference JPEG-style semantics, image_processing.c:104-106).
    """
    if color_range not in ("studio", "full"):
        raise ValueError(
            f"color_range must be 'studio' or 'full', got {color_range!r}"
        )
    bsz, h, w = rgb.shape[:3]
    mbh, mbw = h // 16, w // 16

    if xp is np:
        import contextlib

        scope = lambda _n: contextlib.nullcontext()
    else:
        import jax

        scope = jax.named_scope  # stages attributable in xprof traces

    with scope("color_subsample"):
        if xp is np:
            to_ycbcr = (rgb_to_ycbcr_studio if color_range == "studio"
                        else rgb_to_ycbcr)
            y, cb, cr = to_ycbcr(rgb, xp)
        else:
            # one bitcast to packed u32 instead of three strided reads of
            # the interleaved (..., 3) u8 layout
            from ec504_imageencoder_tpu.ops.color import (
                pack_rgbx_u32,
                rgb_to_ycbcr_packed,
            )

            pix = pack_rgbx_u32(rgb, xp)
            y, cb, cr = rgb_to_ycbcr_packed(pix, xp, color_range)
        cb = subsample_420(cb, xp)
        cr = subsample_420(cr, xp)

    with scope("encode_pack"):
        return correct_pipeline_planes(
            y, cb, cr, intra_q, qscale, max_slice_bytes, xp=xp,
            dct_impl=dct_impl,
        )


@functools.lru_cache(maxsize=16)
def _jitted_correct_pipeline(
    qscale: int, max_slice_bytes: int, dct_impl: str = "aan",
    color_range: str = "studio",
):
    import jax
    import jax.numpy as jnp

    def fn(rgb, intra_q):
        return correct_pipeline(
            rgb, intra_q, qscale, max_slice_bytes, xp=jnp, dct_impl=dct_impl,
            color_range=color_range,
        )

    return jax.jit(fn)


@functools.lru_cache(maxsize=16)
def _jitted_planes_pipeline(
    qscale: int, max_slice_bytes: int, dct_impl: str = "aan",
):
    import jax
    import jax.numpy as jnp

    def fn(y, cb, cr, intra_q):
        return correct_pipeline_planes(
            y, cb, cr, intra_q, qscale, max_slice_bytes, xp=jnp,
            dct_impl=dct_impl,
        )

    return jax.jit(fn)


@functools.lru_cache(maxsize=16)
def _jitted_coeffs_pipeline(height: int, width: int, qscale: int,
                            max_slice_bytes: int, dct_impl: str = "aan"):
    """JPEG coefficients -> device islow IDCT -> padded 4:2:0 planes ->
    MPEG pipeline, one jitted program (the coefficients intake)."""
    import jax
    import jax.numpy as jnp

    from ec504_imageencoder_tpu.ops import jpeg_tpu

    def fn(yc, cbc, crc, intra_q):
        y, cb, cr = jpeg_tpu.decode_planes_from_coeffs(
            yc, cbc, crc, height, width, jnp
        )
        ph, pw = -height % 16, -width % 16
        if ph or pw:
            y = jnp.pad(y, ((0, 0), (0, ph), (0, pw)), mode="edge")
        th, tw = (height + ph) // 2, (width + pw) // 2
        ch, cw = cb.shape[1:3]
        if (ch, cw) != (th, tw):
            pad = ((0, 0), (0, th - ch), (0, tw - cw))
            cb = jnp.pad(cb, pad, mode="edge")
            cr = jnp.pad(cr, pad, mode="edge")
        return correct_pipeline_planes(
            y, cb, cr, intra_q, qscale, max_slice_bytes, xp=jnp,
            dct_impl=dct_impl,
        )

    return jax.jit(fn)


def pad_planes_to_macroblocks(y, cb, cr):
    """Edge-replicate 4:2:0 planes so Y is a multiple of 16 (chroma 8)."""
    h, w = y.shape[1:3]
    ph, pw = -h % 16, -w % 16
    if ph or pw:
        y = np.pad(y, ((0, 0), (0, ph), (0, pw)), mode="edge")
    th, tw = y.shape[1] // 2, y.shape[2] // 2
    ch, cw = cb.shape[1:3]
    if (ch, cw) != (th, tw):
        pad = ((0, 0), (0, th - ch), (0, tw - cw))
        cb = np.pad(cb, pad, mode="edge")
        cr = np.pad(cr, pad, mode="edge")
    return y, cb, cr


def sequence_header_es(
    width: int,
    height: int,
    frame_rate_code: int = 3,
    aspect_code: int = 1,
    vbv_size: int = 20,
    intra_matrix: np.ndarray | None = None,
) -> bytes:
    """Full ISO 11172-2 §2.4.2.3 sequence header with optional custom
    intra quantizer matrix (transmitted in zigzag order)."""
    w = BitWriter()
    w.put_bytes(headers.SEQUENCE_START)
    w.put(width, 12)
    w.put(height, 12)
    w.put(aspect_code, 4)
    w.put(frame_rate_code, 4)
    w.put(0x3FFFF, 18)  # variable bitrate
    w.put(1, 1)         # marker
    w.put(vbv_size, 10)
    w.put(0, 1)         # constrained_parameters_flag
    if intra_matrix is not None:
        w.put(1, 1)     # load_intra_quantizer_matrix
        zz = intra_matrix.reshape(64)[ZIGZAG_GATHER]
        for v in zz.tolist():
            w.put(int(v), 8)
    else:
        w.put(0, 1)
    w.put(0, 1)         # load_non_intra_quantizer_matrix
    w.align(0)
    return w.tobytes()


def gop_header_es(frame_index: int, fps: float, closed: bool = True) -> bytes:
    """GOP header with a real SMPTE-style timecode for the frame index."""
    fps_i = max(1, int(round(fps)))
    total_s, pic = divmod(frame_index, fps_i)
    total_m, sec = divmod(total_s, 60)
    hour, minute = divmod(total_m, 60)
    return headers.gop_header(
        hour=hour, minute=minute, second=sec, num_pic=pic,
        drop_frame=0, closed=1 if closed else 0, broken=0,
    )


class MPEG1IntraEncoder:
    """ISO-compliant all-I-frame MPEG-1 video encoder.

    encode(frames) -> elementary stream bytes.  Device work is batched and
    jitted; host work is header emission + segment concatenation.
    """

    def __init__(
        self,
        quality: int = 50,
        frame_rate_code: int = 3,
        gop_size: int = 15,
        max_slice_bytes: int | None = None,
        backend: str = "jax",
        dct_impl: str = "auto",
        color_range: str = "studio",
        grow_slices: bool = True,
    ):
        if color_range not in ("studio", "full"):
            raise ValueError(
                f"color_range must be 'studio' or 'full', got {color_range!r}"
            )
        self.quality = quality
        self.intra_q, self.qscale = quality_to_quant(quality)
        # the integer AAN's +-2 noise caps PSNR ~40 dB; at fine
        # quantization switch to the f32 matmul DCT automatically.
        # Determinism of the f32 path: Precision.HIGHEST everywhere;
        # byte-identical across mesh shardings of the same backend
        # (locked by tests/test_sharding.py at q=85); across backends
        # (numpy vs XLA CPU vs GPU) equal-PSNR only — rare f32 ties can
        # flip bytes (ops/dct.py matmul_dct docstring).  Pass
        # dct_impl="aan" for bit-determinism across backends at any
        # quality.
        if dct_impl == "auto":
            dct_impl = "f32" if quality >= 70 else "aan"
        self.dct_impl = dct_impl
        self.color_range = color_range
        self.frame_rate_code = frame_rate_code
        self.fps = FRAME_RATE_VALUES[frame_rate_code]
        self.gop_size = gop_size
        # None = auto-size from (quality, frame width) at first encode.
        # An explicit value is a STARTING size, not a cap: like the
        # reference's growable bitvector (bit_vector.c:148-169), an
        # overflowing slice regrows the buffer and re-encodes unless
        # grow_slices=False (which restores the hard OverflowError).
        self.max_slice_bytes = max_slice_bytes
        self.grow_slices = grow_slices
        self.backend = backend
        self.metrics = None  # optional EncodeMetrics sink (CLI --metrics)

    def resolve_slice_bytes(self, mbw: int) -> int:
        """Current slice-buffer size, auto-sized on first use."""
        if self.max_slice_bytes is None:
            self.max_slice_bytes = initial_slice_bytes(self.quality, mbw)
        return self.max_slice_bytes

    def _pipeline_once(self, padded: np.ndarray, msb: int):
        if self.backend == "jax":
            fn = _jitted_correct_pipeline(
                self.qscale, msb, self.dct_impl, self.color_range,
            )
            return fn(padded, self.intra_q)
        return correct_pipeline(
            padded, self.intra_q, self.qscale, msb,
            xp=np, dct_impl=self.dct_impl, color_range=self.color_range,
        )

    def _planes_once(self, planes, msb: int):
        y, cb, cr = planes
        if self.backend == "jax":
            fn = _jitted_planes_pipeline(self.qscale, msb, self.dct_impl)
            return fn(y, cb, cr, self.intra_q)
        return correct_pipeline_planes(
            y, cb, cr, self.intra_q, self.qscale, msb,
            xp=np, dct_impl=self.dct_impl,
        )

    def _run_pipeline(self, padded: np.ndarray):
        return self._run_with_regrow(
            lambda msb: self._pipeline_once(padded, msb),
            padded.shape[2] // 16,
        )

    def _run_with_regrow(self, run_once, mbw: int):
        msb = self.resolve_slice_bytes(mbw)
        need_bits = 0
        for _attempt in range(3):
            seg_dev, bits_dev = run_once(msb)
            bits = np.asarray(bits_dev)
            if int(bits.min(initial=0)) < 0:
                # EC504_DEBUG_CHECKS=1: the slot guard reports violations
                # as negated slice bit counts (_emit_and_pack)
                viol = -bits[bits < 0]
                raise RuntimeError(
                    f"slot invariant violations in {viol.size} slice(s) "
                    f"({int(viol.sum())} total hits) — VLC slot length/"
                    "masking broken; see models.mpeg1.slot_violations"
                )
            need_bits = int(bits.max(initial=0))
            if need_bits <= 8 * msb:
                break
            if not self.grow_slices:
                raise OverflowError(
                    f"slice needs {-(-need_bits // 8)} bytes > "
                    f"max_slice_bytes={msb} and grow_slices=False"
                )
            # nbits is the true cumulative bit count regardless of buffer
            # size (ops/bitpack.py), so one regrow lands exactly
            msb = slice_bytes_bucket(-(-need_bits // 8))
            self.max_slice_bytes = msb
        else:
            raise OverflowError(
                f"slice-buffer regrow did not converge at {msb} bytes"
            )
        # two-step fetch: bit lengths first (tiny), then only the used
        # byte prefix, bucketed to limit recompiles
        used = -(-need_bits // 8)
        bucket = min(max(256, 1 << max(used - 1, 1).bit_length()), msb)
        seg = np.asarray(seg_dev[:, :, :bucket])
        return seg, bits

    def encode(self, frames_rgb: np.ndarray, first_frame_index: int = 0) -> bytes:
        """Encode (B, H, W, 3) uint8 frames into an MPEG-1 video ES.

        `first_frame_index` supports chunked/streaming encodes: GOP
        boundaries and timecodes stay globally consistent, and the header
        set is only emitted at stream start (index 0).  Callers append a
        final `headers.sequence_end()`.
        """
        frames = np.ascontiguousarray(frames_rgb)
        if frames.ndim != 4 or frames.shape[-1] != 3 or frames.dtype != np.uint8:
            raise ValueError(f"expected (B,H,W,3) uint8, got {frames.shape} {frames.dtype}")
        disp_h, disp_w = frames.shape[1:3]
        if disp_w > MAX_WIDTH or disp_h > MAX_HEIGHT:
            # silently wrapping the 12-bit header fields (mpeg1_enc.c:86-88
            # truncates through uint8_t in the reference — quirk Q1) would
            # produce an undecodable stream; refuse instead
            raise ValueError(
                f"frame {disp_w}x{disp_h} exceeds MPEG-1 limits "
                f"({MAX_WIDTH}x{MAX_HEIGHT}: 12-bit sequence-header "
                "dimensions, slice start codes 0x01..0xAF)"
            )
        padded = pad_to_macroblocks(frames)
        seg, bits = self._run_pipeline(padded)
        if self.metrics is not None:
            mbw = padded.shape[2] // 16
            self.metrics.histogram("slice_bits", bits)
            # slice == one MB row, so bits/MB is the row total split evenly
            self.metrics.histogram("bits_per_macroblock", bits / mbw)
        return self.assemble(seg, bits, disp_w, disp_h, first_frame_index)

    def assemble(self, seg, bits, disp_w: int, disp_h: int,
                 first_frame_index: int = 0) -> bytes:
        """Host-side stream assembly from fetched (seg, bits): sequence/
        GOP/picture headers + the used byte prefix of every slice.

        seg is either the (B, S, msb) byte array or the nested row list
        from ops.bitpack.split_compact_slices (already trimmed)."""
        compacted = isinstance(seg, list)
        out = bytearray()
        for i in range(len(seg) if compacted else seg.shape[0]):
            gi = first_frame_index + i
            if gi % self.gop_size == 0:
                out += sequence_header_es(
                    disp_w, disp_h, self.frame_rate_code,
                    intra_matrix=self.intra_q,
                )
                out += gop_header_es(gi, self.fps)
            out += headers.picture_header(temporal_ref=gi % self.gop_size)
            if compacted:
                for row in seg[i]:
                    out += bytes(row)
            else:
                for s in range(seg.shape[1]):
                    nb = (int(bits[i, s]) + 7) // 8
                    out += bytes(seg[i, s, :nb])
        return bytes(out)

    def encode_from_coeffs(self, yc, cbc, crc, height: int, width: int,
                           first_frame_index: int = 0) -> bytes:
        """Encode straight from dequantized JPEG coefficient blocks
        (io/jpeg.decode_coeffs_batch): the host does entropy decode
        only; the islow IDCT (ops/jpeg_tpu.py, bit-exact vs stb_image),
        macroblock padding, and the whole MPEG pipeline run as ONE
        jitted device program.  The right intake when the host is weak
        and the host->device link is fast (coefficients are 2
        bytes/sample vs the planes intake's 1)."""
        ch, cw = -(-height // 2), -(-width // 2)
        exp_y = (-(-height // 8) * -(-width // 8), 64)
        exp_c = (-(-ch // 8) * -(-cw // 8), 64)
        for name, arr, exp in (("Y", yc, exp_y), ("Cb", cbc, exp_c),
                               ("Cr", crc, exp_c)):
            if arr.ndim != 3 or tuple(arr.shape[1:]) != exp:
                raise ValueError(
                    f"{name} coefficients must be (B, {exp[0]}, 64) for "
                    f"{width}x{height} 4:2:0, got {tuple(arr.shape)}"
                )
        if self.backend != "jax":
            from ec504_imageencoder_tpu.ops import jpeg_tpu

            y, cb, cr = jpeg_tpu.decode_planes_from_coeffs(
                np.asarray(yc), np.asarray(cbc), np.asarray(crc),
                height, width, np,
            )
            return self.encode_from_planes(y, cb, cr, first_frame_index)
        if width > MAX_WIDTH or height > MAX_HEIGHT:
            raise ValueError(
                f"frame {width}x{height} exceeds MPEG-1 limits "
                f"({MAX_WIDTH}x{MAX_HEIGHT})"
            )
        mbw = (width + 15) // 16
        seg, bits = self._run_with_regrow(
            lambda msb: _jitted_coeffs_pipeline(
                height, width, self.qscale, msb, self.dct_impl
            )(yc, cbc, crc, self.intra_q),
            mbw,
        )
        if self.metrics is not None:
            self.metrics.histogram("slice_bits", bits)
            self.metrics.histogram("bits_per_macroblock", bits / mbw)
        return self.assemble(seg, bits, width, height, first_frame_index)

    def encode_from_planes(self, y, cb, cr,
                           first_frame_index: int = 0) -> bytes:
        """Encode 4:2:0 YCbCr planes directly (the JPEG-source fast
        path; see correct_pipeline_planes): y (B, H, W) u8, cb/cr
        (B, ceil(H/2), ceil(W/2)) u8 -> MPEG-1 video ES bytes."""
        y = np.ascontiguousarray(y)
        cb = np.ascontiguousarray(cb)
        cr = np.ascontiguousarray(cr)
        if y.ndim != 3 or y.dtype != np.uint8:
            raise ValueError(f"expected (B,H,W) uint8 Y, got {y.shape} {y.dtype}")
        disp_h, disp_w = y.shape[1:3]
        exp = (y.shape[0], -(-disp_h // 2), -(-disp_w // 2))
        if cb.shape != exp or cr.shape != exp:
            raise ValueError(
                f"chroma planes must be {exp}, got {cb.shape}/{cr.shape}"
            )
        if cb.dtype != np.uint8 or cr.dtype != np.uint8:
            raise ValueError(
                f"expected uint8 chroma planes, got {cb.dtype}/{cr.dtype}"
            )
        if disp_w > MAX_WIDTH or disp_h > MAX_HEIGHT:
            raise ValueError(
                f"frame {disp_w}x{disp_h} exceeds MPEG-1 limits "
                f"({MAX_WIDTH}x{MAX_HEIGHT})"
            )
        planes = pad_planes_to_macroblocks(y, cb, cr)
        seg, bits = self._run_with_regrow(
            lambda msb: self._planes_once(planes, msb),
            planes[0].shape[2] // 16,
        )
        if self.metrics is not None:
            mbw = planes[0].shape[2] // 16
            self.metrics.histogram("slice_bits", bits)
            self.metrics.histogram("bits_per_macroblock", bits / mbw)
        return self.assemble(seg, bits, disp_w, disp_h, first_frame_index)

    def encode_to_file(self, frames_rgb: np.ndarray, path: str) -> int:
        data = self.encode(frames_rgb) + headers.sequence_end()
        with open(path, "wb") as f:
            f.write(data)
        return len(data)
