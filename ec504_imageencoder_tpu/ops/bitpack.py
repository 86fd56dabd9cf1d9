"""Variable-length code packing as a data-parallel device op.

Replaces the reference's bit-by-bit bitvector appends (bit_vector.c:13-122)
with a segmented prefix-sum formulation: given per-slot (code, len) arrays
(len 0 = empty slot), compute each code's bit offset with one cumsum, then
split every code into at-most-two 32-bit-word contributions and combine
them with a scatter-add (bit-disjoint adds == OR).  MSB-first within
big-endian 32-bit words, matching MPEG bit order.

`pack_words` is rank-polymorphic: leading axes are batch (frames, slices),
packing runs along the last axis; XLA batches the scatter.  A fused
kernel can replace the scatter if it shows up in profiles; the interface
(codes, lens) -> (words, nbits) stays.
"""

from __future__ import annotations

import numpy as np


def pack_words(codes, lens, max_words: int, xp=np, bit_offset: int = 0):
    """Pack (..., K) uint32 codes of given bit lens into (..., W) uint32 words.

    Returns (words, nbits) where nbits (...,) is the total packed bit count
    (unpadded); bits beyond nbits are zero.  Codes must be <= 32 bits and
    masked to their length (zero-length slots may carry any value; they are
    zeroed here).  `bit_offset` starts the stream that many bits into the
    buffer (bits below it stay zero, nbits includes it) — used to leave
    room for a fixed-size header the host ORs in afterwards.
    """
    codes = xp.where(lens > 0, codes.astype(xp.uint32), xp.uint32(0))
    lens = lens.astype(xp.int32)
    ends = xp.cumsum(lens, axis=-1) + bit_offset
    off = ends - lens  # exclusive prefix sum: bit offset of each code
    nbits = ends[..., -1]

    word = (off >> 5).astype(xp.int32)
    s = (off & 31).astype(xp.int32)
    over = s + lens - 32  # >0: code crosses into the next word

    sh0 = xp.clip(32 - s - lens, 0, 31).astype(xp.uint32)
    w0 = xp.where(
        over > 0,
        codes >> xp.clip(over, 0, 31).astype(xp.uint32),
        codes << sh0,
    )
    sh1 = xp.clip(32 - over, 1, 31).astype(xp.uint32)
    w1 = xp.where(over > 0, codes << sh1, xp.uint32(0))

    if xp is np:
        batch_shape = codes.shape[:-1]
        out = np.zeros(batch_shape + (max_words,), np.uint32)
        flat_out = out.reshape(-1, max_words)
        flat_w = word.reshape(-1, word.shape[-1])
        flat0 = w0.reshape(flat_w.shape)
        flat1 = w1.reshape(flat_w.shape)
        rows = np.repeat(np.arange(flat_w.shape[0]), flat_w.shape[1])
        w_flat = flat_w.reshape(-1)
        v0 = np.where(w_flat < max_words, flat0.reshape(-1), 0)  # drop overflow
        v1 = np.where(w_flat + 1 < max_words, flat1.reshape(-1), 0)
        np.add.at(flat_out, (rows, np.minimum(w_flat, max_words - 1)), v0)
        np.add.at(flat_out, (rows, np.minimum(w_flat + 1, max_words - 1)), v1)
        return out, nbits

    import jax

    # Bit offsets are monotone, so per-word contributions are bit-disjoint
    # (uint32 add == OR) and the scatter indices arrive sorted.
    def pack1(word_i, w0_i, w1_i):
        buf = xp.zeros((max_words,), xp.uint32)
        buf = buf.at[word_i].add(w0_i, mode="drop", indices_are_sorted=True)
        return buf.at[word_i + 1].add(w1_i, mode="drop", indices_are_sorted=True)

    # nested vmap instead of reshape(-1, K): merging the leading axes
    # would interleave (data, rows)-sharded dims under pjit and force
    # GSPMD to insert all-gathers/all-to-alls; batching per-axis keeps
    # the partitioned program collective-free (tests/test_sharding.py
    # asserts this on the compiled HLO)
    pack = pack1
    for _ in range(word.ndim - 1):
        pack = jax.vmap(pack)
    return pack(word, w0, w1), nbits


def words_to_bytes(words, xp=np):
    """(..., W) uint32 big-endian words -> (..., W*4) uint8."""
    w = words.astype(xp.uint32)
    b = xp.stack(
        [
            (w >> 24) & 0xFF,
            (w >> 16) & 0xFF,
            (w >> 8) & 0xFF,
            w & 0xFF,
        ],
        axis=-1,
    ).astype(xp.uint8)
    return b.reshape(words.shape[:-1] + (words.shape[-1] * 4,))


def compact_slices(seg, bits, cap_words: int):
    """Device-side segment compaction: gather every slice's used word
    prefix into one dense buffer so a slow host link fetches ~stream
    bytes instead of the padded (B, S, max_slice_bytes) buffer.

    seg: (B, S, msb) u8 slice buffers (msb % 4 == 0); bits: (B, S) i32.
    Returns (dense (cap_words,) u32, word_offsets (B*S,) i32).  Caller
    picks cap_words >= sum(ceil(bits/32)) + msb//4 (the forward-cover
    scan writes a full msb-sized row at each offset; each next write
    starts exactly where the previous row's garbage tail begins, so only
    the final row leaves a tail — inside the extra msb//4 headroom).

    Host-side reassembly: slice i's bytes are the first ceil(bits_i/8)
    bytes of dense[offs_i : offs_i + ceil(bits_i/32)] viewed as the
    original byte order (dense is a pure bitcast of the byte stream).
    """
    import jax
    import jax.numpy as jnp

    b, s, msb = seg.shape
    assert msb % 4 == 0
    segw = jax.lax.bitcast_convert_type(
        seg.reshape(b * s, msb // 4, 4), jnp.uint32
    )                                               # (N, mw)
    used_w = (bits.reshape(-1) + 31) // 32
    offs = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(used_w)[:-1].astype(jnp.int32)]
    )

    def body(out, x):
        row, off = x
        return jax.lax.dynamic_update_slice(out, row, (off,)), None

    out0 = jnp.zeros((cap_words,), jnp.uint32)
    dense, _ = jax.lax.scan(body, out0, (segw, offs))
    return dense, offs


def split_compact_slices(dense_words: np.ndarray, bits: np.ndarray):
    """Host inverse of compact_slices: (B, S) list-of-bytes views."""
    byts = dense_words.view(np.uint8)
    used_w = (bits.reshape(-1).astype(np.int64) + 31) // 32
    offs = np.concatenate([[0], np.cumsum(used_w)[:-1]])
    nby = (bits.reshape(-1) + 7) // 8
    out = []
    for i in range(bits.size):
        start = int(offs[i]) * 4
        out.append(byts[start : start + int(nby[i])])
    b, s = bits.shape
    return [out[r * s : (r + 1) * s] for r in range(b)]


def pack_bytes(codes, lens, max_bytes: int, xp=np, bit_offset: int = 0):
    """Pack straight to (..., max_bytes) uint8 + bit lengths: the pack step
    of every pipeline, on the host (numpy) and on the device (jnp)."""
    assert max_bytes % 4 == 0
    words, nbits = pack_words(codes, lens, max_bytes // 4, xp=xp,
                              bit_offset=bit_offset)
    return words_to_bytes(words, xp=xp), nbits
