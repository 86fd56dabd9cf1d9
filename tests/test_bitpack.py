"""The device bit pack (ops/bitpack.pack_words under jnp) against the
numpy pack it shares its arithmetic with: words and bit counts exact."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ec504_imageencoder_tpu.ops.bitpack import pack_words


def _masked(rng, lens):
    """Random codes masked to their lengths (len 32 keeps all bits)."""
    raw = rng.integers(0, 1 << 32, lens.shape, dtype=np.uint64)
    mask = (np.uint64(1) << lens.astype(np.uint64)) - np.uint64(1)
    return (raw & mask).astype(np.uint32)


def _case(name, rng):
    """(codes, lens, max_words, bit_offset) for one named case."""
    k = 512
    if name == "random_0_32":
        lens = rng.integers(0, 33, (4, k)).astype(np.int32)
        return _masked(rng, lens), lens, 512, 0
    if name == "all_32_bit":
        lens = np.full((4, k), 32, np.int32)
        return _masked(rng, lens), lens, k, 0
    if name == "all_empty":
        lens = np.zeros((4, k), np.int32)
        return rng.integers(0, 1 << 32, (4, k), dtype=np.uint64).astype(
            np.uint32), lens, 64, 0
    if name == "bit_offset_38":
        lens = rng.integers(0, 31, (4, k)).astype(np.int32)
        return _masked(rng, lens), lens, 512, 38
    if name == "overflow_dropped":
        # ~8k bits into a 64-word (2048-bit) buffer: the tail must drop,
        # never wrap into the buffer's start
        lens = rng.integers(10, 21, (4, k)).astype(np.int32)
        return _masked(rng, lens), lens, 64, 38
    if name == "unmasked_zero_len":
        lens = np.where(rng.random((4, k)) < 0.5,
                        rng.integers(1, 31, (4, k)), 0).astype(np.int32)
        codes = _masked(rng, lens)
        garbage = rng.integers(0, 1 << 32, (4, k), dtype=np.uint64)
        codes = np.where(lens == 0, garbage, codes).astype(np.uint32)
        return codes, lens, 512, 0
    if name == "rank_1_vs_3":
        lens = rng.integers(0, 31, (2, 3, k)).astype(np.int32)
        return _masked(rng, lens), lens, 512, 38
    raise ValueError(name)


CASES = ["random_0_32", "all_32_bit", "all_empty", "bit_offset_38",
         "overflow_dropped", "unmasked_zero_len", "rank_1_vs_3"]


@pytest.mark.parametrize("name", CASES)
def test_pack_words_jnp_matches_numpy(name):
    rng = np.random.default_rng(CASES.index(name))
    codes, lens, max_words, off = _case(name, rng)
    want_w, want_b = pack_words(codes, lens, max_words, xp=np, bit_offset=off)
    fn = jax.jit(lambda c, l: pack_words(c, l, max_words, xp=jnp,
                                         bit_offset=off))
    got_w, got_b = fn(codes, lens)
    np.testing.assert_array_equal(np.asarray(got_w), want_w)
    np.testing.assert_array_equal(np.asarray(got_b), want_b)
    if name == "rank_1_vs_3":
        # leading rank 1: each row packed alone equals its rank-3 slot
        row_w, row_b = jax.jit(lambda c, l: pack_words(
            c, l, max_words, xp=jnp, bit_offset=off))(codes[1, 2], lens[1, 2])
        np.testing.assert_array_equal(np.asarray(row_w), want_w[1, 2])
        assert int(row_b) == int(want_b[1, 2])
    if name == "overflow_dropped":
        assert (want_b > 32 * max_words).all()
    if name == "all_empty":
        assert not want_w.any() and (want_b == 0).all()
