"""EC504_DEBUG_CHECKS=1: the device pipeline checks the slot invariants
the pack relies on (lengths in [0, 30], codes masked to their length) and
reports a violation as a negated slice bit count, which the encoder turns
into a RuntimeError."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ec504_imageencoder_tpu.models.mpeg1 import (
    MPEG1IntraEncoder,
    correct_pipeline,
    quality_to_quant,
)


def test_debug_checks_clean_on_valid_input(monkeypatch, rng):
    monkeypatch.setenv("EC504_DEBUG_CHECKS", "1")
    frames = rng.integers(0, 256, (2, 32, 48, 3), dtype=np.uint8)
    intra_q, qscale = quality_to_quant(50)
    # a fresh jit, so the guard is traced with the variable set
    fn = jax.jit(lambda f, q: correct_pipeline(f, q, qscale, 4096, xp=jnp))
    seg, bits = (np.asarray(a) for a in fn(frames, intra_q))
    want_seg, want_bits = correct_pipeline(frames, intra_q, qscale, 4096, xp=np)
    assert (bits > 0).all()
    np.testing.assert_array_equal(bits, want_bits)
    np.testing.assert_array_equal(seg, want_seg)


@pytest.mark.parametrize("fault", ["length_out_of_range", "code_beyond_length"])
def test_slot_violation_detected(fault, monkeypatch, rng):
    """Corrupt one slot of the VLC emission: the traced guard counts it
    per slice and the encoder raises."""
    from ec504_imageencoder_tpu.models import mpeg1

    real = mpeg1.block_streams_correct64

    def corrupted(*args, **kwargs):
        codes, lens = real(*args, **kwargs)
        if fault == "length_out_of_range":
            lens = lens.at[0, 1, 2, 3, 5].set(31)
        else:
            lens = lens.at[0, 1, 2, 3, 5].set(4)
            codes = codes.at[0, 1, 2, 3, 5].set(0b110000)  # bit 5 > 4 bits
        return codes, lens

    monkeypatch.setenv("EC504_DEBUG_CHECKS", "1")
    monkeypatch.setattr(mpeg1, "block_streams_correct64", corrupted)
    frames = rng.integers(0, 256, (2, 32, 48, 3), dtype=np.uint8)
    intra_q, qscale = quality_to_quant(50)
    fn = jax.jit(lambda f, q: correct_pipeline(f, q, qscale, 4096, xp=jnp))
    bits = np.asarray(fn(frames, intra_q)[1])
    expect = np.zeros_like(bits, dtype=bool)
    expect[0, 1] = True  # frame 0, slice (MB row) 1
    np.testing.assert_array_equal(bits < 0, expect)
    assert int(bits[0, 1]) == -1

    mpeg1._jitted_correct_pipeline.cache_clear()  # trace with the fault
    try:
        with pytest.raises(RuntimeError, match="slot invariant violations"):
            MPEG1IntraEncoder(quality=50).encode(frames)
    finally:
        mpeg1._jitted_correct_pipeline.cache_clear()
