"""Unit tests for the numeric ops, numpy backend.

The AAN kernel's ground truth is the naive float DCT (the reference keeps
the same oracle relationship: image_processing.c:157 vs :192); exactness
against the reference C binary was established by harness dumps and is
locked in by the golden bitstream test.
"""

import numpy as np
import pytest

from ec504_imageencoder_tpu.ops import color, dct, quant, zigzag
from ec504_imageencoder_tpu.utils import tables


def test_zigzag_roundtrip(rng):
    blocks = rng.integers(-300, 300, size=(17, 8, 8), dtype=np.int32)
    zz = zigzag.zigzag_scan(blocks)
    assert zz.shape == (17, 64)
    back = zigzag.zigzag_descan(zz)
    np.testing.assert_array_equal(back, blocks)


def test_zigzag_order_spot():
    # position (0,1) is scan index 1, (1,0) is 2, (7,7) is 63
    b = np.zeros((8, 8), np.int32)
    b[0, 1] = 5
    assert zigzag.zigzag_scan(b)[1] == 5
    b = np.zeros((8, 8), np.int32)
    b[7, 7] = 9
    assert zigzag.zigzag_scan(b)[63] == 9


def test_aan_dct_close_to_naive(rng):
    blocks = rng.integers(0, 256, size=(64, 8, 8)).astype(np.uint8)
    fast = dct.aan_dct(blocks)
    for i in range(8):
        naive = dct.naive_dct_f64(blocks[i])
        assert np.abs(fast[i] - naive).max() < 4.0  # fixed-point error bound


def test_aan_dct_dc_value():
    flat = np.full((1, 8, 8), 200, np.uint8)
    out = dct.aan_dct(flat)
    # DC of a flat block ~ 8*mean, all ACs ~ 0 for the AAN fixed point
    assert abs(int(out[0, 0, 0]) - 1600) <= 4
    assert np.abs(out[0].reshape(-1)[1:]).max() <= 2


def test_quantize_truncates_toward_zero():
    q = np.full((8, 8), 10, np.int32)
    d = np.zeros((8, 8), np.int32)
    d[0, 0] = -19
    d[0, 1] = 19
    out = quant.quantize(d, q)
    assert out[0, 0] == -1 and out[0, 1] == 1


def test_scale_quantization_matrix_reference_values():
    q12 = tables.scale_quantization_matrix(12)
    # independently computed from the C formula (f32 product, round, trunc)
    assert q12[0, 0] == 33 and q12[7, 7] == 346
    assert tables.scale_quantization_matrix(50).tolist() == tables.INTRA_Q_MATRIX.tolist()
    assert tables.scale_quantization_matrix(100).min() == 1
    # clamping
    assert (tables.scale_quantization_matrix(1) >= 1).all()


def test_color_device_kernel_close_to_exact(rng):
    """The deterministic fixed-point device kernel stays within 1 LSB of
    the C-double-exact path (they round differently at half-points)."""
    rgb = rng.integers(0, 256, size=(64, 64, 3)).astype(np.uint8)
    y1, cb1, cr1 = color.rgb_to_ycbcr_exact(rgb)
    y2, cb2, cr2 = color.rgb_to_ycbcr(rgb)
    for a, b in [(y1, y2), (cb1, cb2), (cr1, cr2)]:
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_color_exact_gray_truncation():
    # r=g=b: the double sums land a hair below the exact value for some x,
    # so C truncation yields x-1 / 127 — THE bit-exactness trap that rules
    # out f32 for compat mode.  Pin the exact C-semantics values.
    x = np.arange(256, dtype=np.uint8)
    rgb = np.stack([x] * 3, axis=-1).reshape(1, 256, 3)
    y, cb, cr = color.rgb_to_ycbcr_exact(rgb)
    assert set(np.unique(cb)) <= {127, 128} and set(np.unique(cr)) <= {127, 128}
    # at least one truncation case exists, and y is x or x-1 everywhere
    assert (cb == 127).any() or (cr == 127).any()
    d = x.astype(int) - y[0].astype(int)
    assert set(np.unique(d)) <= {0, 1}


def test_subsample_420_box_average():
    p = np.arange(16, dtype=np.uint8).reshape(4, 4)
    s = color.subsample_420(p)
    assert s.shape == (2, 2)
    assert s[0, 0] == (0 + 1 + 4 + 5) // 4


def test_subsample_420_jnp_matches_numpy(rng):
    """The jnp path lowers via lax.reduce_window; it must stay value-
    identical to the numpy reshape-sum formulation (floor of the 2x2 sum)."""
    import jax.numpy as jnp

    for shape in ((6, 8), (2, 64, 96), (1, 3, 32, 48)):
        p = rng.integers(0, 256, shape, dtype=np.uint8)
        want = color.subsample_420(p, np)
        got = np.asarray(color.subsample_420(jnp.asarray(p), jnp))
        assert np.array_equal(want, got), shape


def test_aan_idct_roundtrip_quality(rng):
    """Forward AAN then reference-style inverse reconstructs within a small
    error for smooth blocks (the reference inverse is quirky; just sanity)."""
    base = rng.integers(100, 156, size=(4, 8, 8)).astype(np.uint8)
    coeffs = dct.aan_dct(base)
    rec = dct.aan_idct(coeffs)
    assert rec.shape == base.shape


def test_vlc_tables_prefix_free():
    """Every (code,len) family used in one context must be prefix-free."""

    def assert_prefix_free(pairs):
        seen = [(int(c), int(l)) for c, l in pairs if l > 0]
        assert len(seen) == len(set(seen)), "duplicate codes in table"
        for i, (c1, l1) in enumerate(seen):
            for j, (c2, l2) in enumerate(seen):
                if i == j:
                    continue
                if l2 >= l1 and (c2 >> (l2 - l1)) == c1:
                    raise AssertionError(f"{c1:0{l1}b} prefixes {c2:0{l2}b}")

    assert_prefix_free(zip(tables.DC_SIZE_LUMA_CODE, tables.DC_SIZE_LUMA_LEN))
    assert_prefix_free(zip(tables.DC_SIZE_CHROMA_CODE, tables.DC_SIZE_CHROMA_LEN))
    assert_prefix_free(
        zip(tables.MB_ADDRESS_CODE[1:34], tables.MB_ADDRESS_LEN[1:34])
    )
    # AC table incl. EOB ("10"), escape ("000001") and the not-first 1 ("11");
    # correct-mode codes carry a trailing sign bit so compare without it.
    ac = [(0b10, 2), (0b000001, 6), (0b11, 2)]
    for r in range(32):
        for l in range(41):
            if tables.AC_LEN_CORRECT[r, l]:
                ac.append((int(tables.AC_CODE_CORRECT[r, l]), int(tables.AC_LEN_CORRECT[r, l])))
    assert_prefix_free(ac)


@pytest.mark.parametrize("compat", [False, True])
def test_ac_table_device_lookup_matches_dense_lut(compat):
    """The rank-compressed 112-entry gather (ops/vlc_lut.py, the device
    path) equals the dense (run, level) LUTs the host path reads, for
    every run/level including rows that do not exist and the compat
    table's (16, 2) typo.  Compat (0, 1) is left out: ac_codes_compat
    emits its special '11' code without reading the table."""
    import jax.numpy as jnp

    from ec504_imageencoder_tpu.ops.vlc_device import _ac_table

    ri, al = np.meshgrid(np.arange(34), np.arange(1, 43), indexing="ij")
    ri, al = ri.astype(np.int32), al.astype(np.int32)
    want_c, want_l = _ac_table(ri, al, compat, np)
    got_c, got_l = _ac_table(jnp.asarray(ri), jnp.asarray(al), compat, jnp)
    used = ~((ri == 0) & (al == 1)) if compat else np.ones(ri.shape, bool)
    np.testing.assert_array_equal(np.asarray(got_l)[used], want_l[used])
    np.testing.assert_array_equal(np.asarray(got_c)[used], want_c[used])


def test_packed_rgbx_color_matches_sliced():
    """Bitcast RGBX deinterleave (incl. byte order) equals the sliced path."""
    import jax.numpy as jnp

    from ec504_imageencoder_tpu.ops.color import (
        pack_rgbx_u32,
        rgb_to_ycbcr,
        rgb_to_ycbcr_packed,
        rgb_to_ycbcr_studio,
    )

    rng = np.random.default_rng(9)
    rgb = rng.integers(0, 256, (2, 32, 48, 3), dtype=np.uint8)
    pix = pack_rgbx_u32(jnp.asarray(rgb), jnp)
    for rng_name, ref_fn in (("studio", rgb_to_ycbcr_studio),
                             ("full", rgb_to_ycbcr)):
        want = ref_fn(rgb, np)
        got = rgb_to_ycbcr_packed(pix, jnp, rng_name)
        for w, g in zip(want, got):
            assert np.array_equal(w, np.asarray(g)), rng_name
