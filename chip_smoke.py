#!/usr/bin/env python3
"""Smoke run of the encoder's main path on one NVIDIA GPU.

    python chip_smoke.py              # one GPU: every phase below
    python chip_smoke.py --four-gpus  # four GPUs: the sharded path only

Drives the entry points a user calls, at 1080p, and compares each device
result with the host numpy oracle (backend="numpy"):

  1. the card (nvidia-smi name + power limit) and the JAX version;
  2. the native JPEG decoder, built from source;
  3. RGB / planes / coefficients intakes at q=50 (0 differing bytes),
     q=85 on the f32 DCT (decoded PSNR within 0.05 dB of the oracle's),
     compat mode (bytes equal tests/golden/awesome_video.mpeg) and the
     bit pack on a 1080p-sized slot tensor (exact);
  4. api.encode_jpeg_folder on a 32-frame 1080p JPEG folder;
  5. the CLI's --stream --intake ycbcr on that folder;
  6. compile seconds and frames/s of a 16x1080p q=50 encode (a smoke
     figure, not a benchmark).

Exits non-zero, printing no result line, when JAX finds no GPU or any
phase fails.  The last stdout line is the result:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
Everything runs in this one process, which holds the card's memory.
"""

from __future__ import annotations

import os

# ask for the CUDA platform before JAX loads: without the plugin the run
# must fail, not fall back to the CPU
os.environ["JAX_PLATFORMS"] = "cuda"

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "tests", "golden")
JPEG1080 = os.path.join(GOLDEN, "jpeg1080")
H, W = 1080, 1920
BATCH = 16  # the CLI's default --batch


def texture_frames(n: int, seed: int) -> np.ndarray:
    """(n, 1080, 1920, 3) u8 smooth pattern + uniform noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    out = np.empty((n, H, W, 3), np.uint8)
    for i in range(n):
        base = (np.sin(xx / 23 + i) + np.cos(yy / 17)) * 60 + 128
        out[i] = np.clip(
            base[:, :, None] + rng.integers(0, 24, (H, W, 3)), 0, 255
        )
    return out


def stage_jpeg_folder(dst: str, n: int) -> list[str]:
    """Copy the committed 1080p JPEGs into dst until it holds n files."""
    src = sorted(os.path.join(JPEG1080, f) for f in os.listdir(JPEG1080))
    paths = []
    for i in range(n):
        p = os.path.join(dst, f"frame_{i:04d}.jpg")
        shutil.copyfile(src[i % len(src)], p)
        paths.append(p)
    return paths


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()


class Smoke:
    def __init__(self):
        self.failed = []

    def phase(self, name, fn, *args):
        t0 = time.perf_counter()
        try:
            msg = fn(*args)
        except Exception as e:  # a failed phase fails the run, later
            traceback.print_exc()
            self.failed.append(name)
            print(f"[FAIL] {name}: {type(e).__name__}: {e}", flush=True)
            return None
        print(f"[ok] {name} ({time.perf_counter() - t0:.1f} s): {msg}",
              flush=True)
        return msg


# -- phases ---------------------------------------------------------------

def native_decoder():
    from ec504_imageencoder_tpu.io import jpeg as jpeg_io

    t0 = time.perf_counter()
    lib = jpeg_io._load_native()
    return f"built + loaded {lib._name} in {time.perf_counter() - t0:.1f} s"


def rgb_q50(frames):
    from ec504_imageencoder_tpu.models.mpeg1 import MPEG1IntraEncoder

    dev = MPEG1IntraEncoder(quality=50).encode(frames)
    ref = MPEG1IntraEncoder(quality=50, backend="numpy").encode(frames)
    return _same_bytes(dev, ref, f"{len(frames)} frames")


def _same_bytes(got: bytes, want: bytes, what: str) -> str:
    if got != want:
        n = min(len(got), len(want))
        diff = int(np.count_nonzero(
            np.frombuffer(got[:n], np.uint8) != np.frombuffer(want[:n], np.uint8)
        )) + abs(len(got) - len(want))
        raise AssertionError(f"{what}: {diff} differing bytes "
                             f"({len(got)} vs oracle {len(want)})")
    return f"{what}, {len(got)} bytes, 0 differing bytes vs numpy oracle"


def planes_q50(paths):
    from ec504_imageencoder_tpu.io import jpeg as jpeg_io
    from ec504_imageencoder_tpu.models.mpeg1 import MPEG1IntraEncoder

    g = jpeg_io.probe_jpeg(paths[0])
    y, cb, cr = jpeg_io.decode_planes_batch(paths, g)
    dev = MPEG1IntraEncoder(quality=50).encode_from_planes(y, cb, cr)
    ref = MPEG1IntraEncoder(quality=50, backend="numpy").encode_from_planes(
        y, cb, cr)
    return _same_bytes(dev, ref, f"{len(paths)} JPEG frames")


def coeffs_q50(paths):
    from ec504_imageencoder_tpu.io import jpeg as jpeg_io
    from ec504_imageencoder_tpu.models.mpeg1 import MPEG1IntraEncoder

    g = jpeg_io.probe_jpeg(paths[0])
    yc, cbc, crc = jpeg_io.decode_coeffs_batch(paths, g)
    y, cb, cr = jpeg_io.decode_planes_batch(paths, g)
    dev = MPEG1IntraEncoder(quality=50).encode_from_coeffs(
        yc, cbc, crc, g["height"], g["width"])
    want = MPEG1IntraEncoder(quality=50).encode_from_planes(y, cb, cr)
    return _same_bytes(dev, want, f"{len(paths)} JPEG frames vs planes intake")


def f32_q85(frames):
    from ec504_imageencoder_tpu.models.decoder import decode_es_fast, psnr
    from ec504_imageencoder_tpu.models.mpeg1 import (
        MPEG1IntraEncoder,
        pad_to_macroblocks,
    )
    from ec504_imageencoder_tpu.syntax import headers

    padded = pad_to_macroblocks(frames)
    streams, slices = [], []
    for backend in ("jax", "numpy"):
        enc = MPEG1IntraEncoder(quality=85, backend=backend)
        assert enc.dct_impl == "f32"
        seg, bits = enc._run_pipeline(padded)
        slices.append([bytes(seg[i, s, :(int(bits[i, s]) + 7) // 8])
                       for i in range(seg.shape[0])
                       for s in range(seg.shape[1])])
        streams.append(enc.assemble(seg, bits, W, H) + headers.sequence_end())
    differ = sum(a != b for a, b in zip(*slices))
    p = []
    for es in streams:
        dec = decode_es_fast(es, color_range="studio")
        p.append(float(np.mean([psnr(f, d) for f, d in zip(frames, dec)])))
    delta = abs(p[0] - p[1])
    if delta > 0.05:
        raise AssertionError(f"PSNR {p[0]:.4f} dB vs oracle {p[1]:.4f} dB")
    return (f"{len(frames)} frames, PSNR {p[0]:.4f} dB vs oracle "
            f"{p[1]:.4f} dB (|delta| {delta:.4f} <= 0.05); "
            f"{differ}/{len(slices[0])} slices differ "
            f"({differ / len(slices[0]):.4%})")


def compat():
    from ec504_imageencoder_tpu.models.encoder import encode_compat

    with np.load(os.path.join(GOLDEN, "fixture_rgb.npz")) as z:
        fixtures = {k: z[k] for k in z.files}
    with open(os.path.join(GOLDEN, "frame_order.json")) as f:
        order = json.load(f)["unique_ids"]
    frames = np.stack([fixtures[k] for k in order])
    with open(os.path.join(GOLDEN, "awesome_video.mpeg"), "rb") as f:
        golden = f.read()
    data, _ = encode_compat(frames, 12, backend="jax")
    return _same_bytes(data, golden,
                       f"{len(frames)} fixture frames vs awesome_video.mpeg")


def pack(seed: int):
    import jax
    import jax.numpy as jnp

    from ec504_imageencoder_tpu.models.mpeg1 import initial_slice_bytes
    from ec504_imageencoder_tpu.ops.bitpack import pack_words

    rng = np.random.default_rng(seed)
    mbw = -(-W // 16)
    shape = (4, -(-H // 16), mbw * 6 * 64)  # frames x slices x slots
    lens = np.where(rng.random(shape) < 0.15,
                    rng.integers(1, 31, shape), 0).astype(np.int32)
    lens[0, 0] = 30  # one slice overflows: its tail must drop, not wrap
    codes = (rng.integers(0, 1 << 32, shape, dtype=np.uint64)
             & ((1 << lens.astype(np.uint64)) - 1)).astype(np.uint32)
    max_words = initial_slice_bytes(50, mbw) // 4
    fn = jax.jit(lambda c, l: pack_words(c, l, max_words, xp=jnp,
                                         bit_offset=38))
    got_w, got_b = (np.asarray(a) for a in fn(codes, lens))
    want_w, want_b = pack_words(codes, lens, max_words, xp=np, bit_offset=38)
    if not (np.array_equal(got_w, want_w) and np.array_equal(got_b, want_b)):
        bad = int(np.count_nonzero(got_w != want_w))
        raise AssertionError(f"{bad} differing words")
    return (f"{codes.size} slots -> {got_w.shape} words, exact "
            "(incl. one overflowing slice)")


def jpeg_folder(folder: str, out: str):
    from ec504_imageencoder_tpu.api import encode_jpeg_folder
    from ec504_imageencoder_tpu.io.stream import FolderFrameSource
    from ec504_imageencoder_tpu.models.decoder import decode_es_fast
    from ec504_imageencoder_tpu.models.mpeg1 import MPEG1IntraEncoder
    from ec504_imageencoder_tpu.syntax import headers

    t0 = time.perf_counter()
    n = encode_jpeg_folder(folder, out, quality=50, batch_size=BATCH)
    wall = time.perf_counter() - t0
    with open(out, "rb") as f:
        data = f.read()
    assert n == len(data)
    src = FolderFrameSource(folder)
    oracle = MPEG1IntraEncoder(quality=50, backend="numpy")
    want = b"".join(oracle.encode_from_planes(y, cb, cr, first_frame_index=s)
                    for s, (y, cb, cr) in src.plane_batches(BATCH))
    msg = _same_bytes(data, want + headers.sequence_end(),
                      f"{len(src)} frames (wall {wall:.1f} s incl. compile)")
    dec = decode_es_fast(data, color_range="studio")
    if len(dec) != len(src):
        raise AssertionError(f"stream decodes to {len(dec)} frames")
    return f"{msg}; decodes to {len(dec)} frames"


def cli_stream(folder: str, out: str, api_out: str):
    from ec504_imageencoder_tpu.cli import main
    from ec504_imageencoder_tpu.models.decoder import decode_es_fast

    rc = main([folder, "-o", out, "--stream", "--intake", "ycbcr"])
    assert rc == 0, rc
    with open(out, "rb") as f:
        data = f.read()
    with open(api_out, "rb") as f:
        want = f.read()
    msg = _same_bytes(data, want, "CLI stream vs api.encode_jpeg_folder")
    dec = decode_es_fast(data, color_range="studio")
    if len(dec) != len(os.listdir(folder)):
        raise AssertionError(f"stream decodes to {len(dec)} frames")
    return f"{msg}; decodes to {len(dec)} frames"


def timing(frames, card: str):
    import jax

    from ec504_imageencoder_tpu.models.mpeg1 import (
        MPEG1IntraEncoder,
        _jitted_correct_pipeline,
        pad_to_macroblocks,
    )

    enc = MPEG1IntraEncoder(quality=50)
    padded = pad_to_macroblocks(frames)
    msb = enc.resolve_slice_bytes(padded.shape[2] // 16)
    fn = _jitted_correct_pipeline(enc.qscale, msb, enc.dct_impl,
                                  enc.color_range)
    x = jax.device_put(padded)
    q = jax.device_put(enc.intra_q)
    t0 = time.perf_counter()
    compiled = fn.lower(x, q).compile()
    compile_s = time.perf_counter() - t0
    jax.block_until_ready(compiled(x, q))
    steps = []
    for _ in range(10):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(x, q))
        steps.append(time.perf_counter() - t0)
    enc.encode(frames)  # warm the encode path (fetch and assembly shapes)
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        enc.encode(frames)
        walls.append(time.perf_counter() - t0)
    step, wall = float(np.median(steps)), float(np.median(walls))
    n = len(frames)
    return (f"smoke figure, not a benchmark ({card}): compile {compile_s:.1f} s;"
            f" device step on resident frames {step * 1e3:.2f} ms = "
            f"{n / step:.1f} frames/s; encode() host frames -> bytes "
            f"{wall * 1e3:.1f} ms = {n / wall:.1f} frames/s "
            f"({n}x{W}x{H} q=50, medians of 10 / 3)")


def four_gpus(frames):
    import __graft_entry__
    from ec504_imageencoder_tpu.models.mpeg1 import MPEG1IntraEncoder
    from ec504_imageencoder_tpu.ops.color import (
        rgb_to_ycbcr_studio,
        subsample_420,
    )
    from ec504_imageencoder_tpu.parallel import mesh as mesh_lib
    from ec504_imageencoder_tpu.parallel.sharded_encoder import (
        ShardedMPEG1Encoder,
    )

    y, cb, cr = rgb_to_ycbcr_studio(frames, np)
    cb, cr = subsample_420(cb, np), subsample_420(cr, np)
    single = MPEG1IntraEncoder(quality=50)
    want_rgb = single.encode(frames)
    want_planes = single.encode_from_planes(y, cb, cr)
    out = []
    for shape in ((4, 1), (2, 2)):
        enc = ShardedMPEG1Encoder(quality=50, mesh=mesh_lib.make_mesh(*shape))
        _same_bytes(enc.encode(frames), want_rgb, f"mesh {shape} RGB")
        _same_bytes(enc.encode_from_planes(y, cb, cr), want_planes,
                    f"mesh {shape} planes")
        out.append(f"mesh {shape}: RGB {len(want_rgb)} B + planes "
                   f"{len(want_planes)} B byte-identical to one GPU")
    __graft_entry__.dryrun_multichip(4)
    return "; ".join(out) + "; dryrun_multichip(4) ok"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the sharded path on four GPUs")
    args = ap.parse_args(argv)

    import jax

    try:
        devices = jax.devices()
    except Exception as e:  # JAX raises more than one type for this
        print(f"no GPU: {type(e).__name__}: {e}", file=sys.stderr)
        return 2
    need = 4 if args.four_gpus else 1
    if devices[0].platform != "gpu" or len(devices) < need:
        print(f"need {need} GPU(s), JAX has {devices}", file=sys.stderr)
        return 2

    from ec504_imageencoder_tpu.utils.compile_cache import enable_compile_cache

    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"jax {jax.__version__}; {len(devices)} x {devices[0].device_kind}; "
          f"compile cache {enable_compile_cache()}", flush=True)

    s = Smoke()
    if args.four_gpus:
        s.phase("four GPUs: sharded 16x1080p q=50 vs one GPU", four_gpus,
                texture_frames(BATCH, 1))
    else:
        s.phase("native JPEG decoder", native_decoder)
        frames4 = texture_frames(4, 2)
        with tempfile.TemporaryDirectory() as tmp:
            folder = os.path.join(tmp, "jpegs")
            os.mkdir(folder)
            paths = stage_jpeg_folder(folder, 32)
            s.phase("RGB intake q=50", rgb_q50, frames4)
            s.phase("planes intake q=50", planes_q50, paths[:4])
            s.phase("coefficients intake q=50", coeffs_q50, paths[:4])
            s.phase("q=85 f32 DCT", f32_q85, frames4)
            s.phase("compat mode", compat)
            s.phase("pack_words", pack, 3)
            api_out = os.path.join(tmp, "api.mpeg")
            s.phase("api.encode_jpeg_folder", jpeg_folder, folder, api_out)
            s.phase("CLI --stream --intake ycbcr", cli_stream, folder,
                    os.path.join(tmp, "cli.mpeg"), api_out)
        s.phase("16x1080p q=50 timing", timing, texture_frames(BATCH, 1), card)
    if s.failed:
        print(f"failed phases: {s.failed}", file=sys.stderr)
        return 1
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
