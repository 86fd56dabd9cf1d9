#!/usr/bin/env python3
"""Benchmark harness.

Headline metric (BASELINE.json): encoded frames/s at 1080p, measured on
the correct-mode device pipeline with device-resident frames, plus an
end-to-end JPEG folder -> .mpeg run, which separates JPEG decode (host)
from encode (device).  Every result names the device kind and the
card's power limit; device times end in block_until_ready.

vs_baseline: the reference C encoder is re-built and re-run on its fixture
workload per run (BASELINE.md demands re-measurement, the reference
publishes no numbers).  The reference only ever encodes a hard 96x144
crop (SURVEY.md Q2), so its frames/s is converted to an area-normalized
1080p-equivalent rate for comparison.

Prints exactly one JSON line:
  {"metric": ..., "value": N, "unit": "frames/s", "vs_baseline": N}
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

REF_SRC = "/root/reference"
REF_BUILD = "/tmp/ec504_bench_ref"

W1080, H1080 = 1920, 1080
PAD_H = 1088  # 1080 padded to MB multiple
BATCH = int(os.environ.get("EC504_BENCH_BATCH", "16"))  # CLI --batch default
QUALITY = 50
ITERS = int(os.environ.get("EC504_BENCH_ITERS", "5"))

_T0 = time.time()


def _log(msg: str) -> None:
    print(f"[bench +{time.time() - _T0:7.1f}s] {msg}", file=sys.stderr, flush=True)


def measure_reference() -> dict:
    """Build + run the reference C encoder on its fixtures; frames/s."""
    try:
        if not os.path.exists(os.path.join(REF_BUILD, "encoder")):
            shutil.rmtree(REF_BUILD, ignore_errors=True)
            shutil.copytree(REF_SRC, REF_BUILD)
            subprocess.run(["make", "all"], cwd=REF_BUILD, check=True,
                           capture_output=True)
            subprocess.run(["unzip", "-q", "images.zip", "-d", "imgdir"],
                           cwd=REF_BUILD, check=True)
            os.makedirs(os.path.join(REF_BUILD, "images"), exist_ok=True)
            for f in os.listdir(os.path.join(REF_BUILD, "imgdir")):
                shutil.copy(os.path.join(REF_BUILD, "imgdir", f),
                            os.path.join(REF_BUILD, "images", f))
        os.makedirs(os.path.join(REF_BUILD, "bitstreams"), exist_ok=True)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            subprocess.run(["./encoder"], cwd=REF_BUILD, check=True,
                           stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
            best = min(best, time.perf_counter() - t0)
        n_frames = 30
        fps_crop = n_frames / best
        # area-normalize the 96x144 crop to a 1080p frame
        fps_1080_equiv = fps_crop * (96 * 144) / (W1080 * PAD_H)
        return {"wall_s": best, "fps_crop": fps_crop,
                "fps_1080_equiv": fps_1080_equiv}
    except Exception as e:  # reference unavailable: report absolute only
        return {"error": str(e), "fps_1080_equiv": None}


def measure_device_1080p() -> dict:
    import jax
    import jax.numpy as jnp

    from ec504_imageencoder_tpu.models.mpeg1 import (
        _jitted_correct_pipeline,
        initial_slice_bytes,
        quality_to_quant,
    )

    dev = jax.devices()[0]
    _log(f"device: {dev}")
    intra_q, qscale = quality_to_quant(QUALITY)
    # the encoder's own auto sizing (initial_slice_bytes); the assert
    # below guards truncation
    max_slice_bytes = initial_slice_bytes(QUALITY, W1080 // 16)
    fn = _jitted_correct_pipeline(qscale, max_slice_bytes)

    # Generate the frame batch ON DEVICE (white-noise worst-case content
    # from a multiply-xorshift hash of an iota): the metric is the device
    # pipeline on device-resident frames (BASELINE.md separates host
    # decode and upload).
    def hash_frames():
        n = BATCH * PAD_H * W1080 * 3
        i = jax.lax.iota(jnp.uint32, n)
        x = i * jnp.uint32(2654435761)
        x = x ^ (x >> 15)
        x = x * jnp.uint32(2246822519)
        x = x ^ (x >> 13)
        return (x & jnp.uint32(0xFF)).astype(jnp.uint8).reshape(
            BATCH, PAD_H, W1080, 3
        )

    frames_dev = jax.block_until_ready(jax.jit(hash_frames)())
    intra_dev = jax.device_put(intra_q)

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(frames_dev, intra_dev))
    t_compile = time.perf_counter() - t0
    _log(f"compiled + first run in {t_compile:.1f}s")

    times = []
    for i in range(ITERS):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(frames_dev, intra_dev))
        times.append(time.perf_counter() - t0)
        _log(f"iter {i + 1}/{ITERS}: {times[-1]:.4f}s")
    step = float(np.median(times))

    bits = np.asarray(out[1])
    # correct_pipeline itself has no overflow guard (only the encoder API
    # regrows); fail loudly rather than report bit counts from truncated
    # slices
    assert int(bits.max()) <= 8 * max_slice_bytes, (
        f"slice overflow: {int(bits.max())} bits > {8 * max_slice_bytes}"
    )
    total_bytes = int(((bits + 7) // 8).sum())
    return {
        "device_kind": dev.device_kind,
        "platform": dev.platform,
        "fps": BATCH / step,
        "step_s": step,
        "step_s_all": times,
        "method": "median single dispatch, block_until_ready",
        "compile_s": t_compile,
        "stream_bytes_per_frame": total_bytes // BATCH,
    }


E2E_FRAMES = int(os.environ.get("EC504_BENCH_E2E_FRAMES", "48"))


def measure_end_to_end() -> dict:
    """JPEG folder -> .mpeg wall-clock fps with the stages overlapped:
    threaded host entropy-decode+IDCT to YCbCr planes (FolderFrameSource
    lookahead), async device_put upload, device encode from planes,
    bucketed fetch of the used slice prefixes.  Replaces the reference's
    host-only load-all pipeline (encoder.h:126-171, stb_image.h:2430-2523).

    The planes intake (io/jpeg.decode_planes_batch + encode_from_planes)
    skips the JPEG back-half's resample/color on the host AND the
    encoder's color/subsample on device, and uploads 1.5 bytes/px
    instead of RGB's 3; the component timings are reported so the
    end-to-end time is attributable."""
    import jax

    from ec504_imageencoder_tpu.io.stream import FolderFrameSource
    from ec504_imageencoder_tpu.models.mpeg1 import (
        MPEG1IntraEncoder,
        _jitted_planes_pipeline,
        pad_planes_to_macroblocks,
    )
    from ec504_imageencoder_tpu.syntax import headers

    from chip_smoke import stage_jpeg_folder

    folder = tempfile.mkdtemp(prefix="ec504_e2e_")
    stage_jpeg_folder(folder, E2E_FRAMES)
    src = FolderFrameSource(folder)
    n = len(src)
    if not src.supports_planes():
        return {"error": "planes intake unsupported for staged JPEGs"}

    enc = MPEG1IntraEncoder(quality=QUALITY)
    msb = enc.resolve_slice_bytes(W1080 // 16)
    fn = _jitted_planes_pipeline(enc.qscale, msb, enc.dct_impl)
    intra_dev = jax.device_put(enc.intra_q)

    import jax as _jax

    from ec504_imageencoder_tpu.ops.bitpack import (
        compact_slices,
        split_compact_slices,
    )

    compact_jit = _jax.jit(compact_slices, static_argnums=2)
    # fixed compaction capacity (device scratch, fetched only up to the
    # used words) so the 1088-step scan compiles ONCE, outside the timed
    # loop
    mbh = PAD_H // 16
    cap = 1 << (BATCH * mbh * (msb // 4) + msb // 4 - 1).bit_length()

    # compile + warm outside the timed loop
    warm = (np.zeros((BATCH, PAD_H, W1080), np.uint8),
            np.zeros((BATCH, PAD_H // 2, W1080 // 2), np.uint8),
            np.zeros((BATCH, PAD_H // 2, W1080 // 2), np.uint8))
    wd = [jax.device_put(p) for p in warm]
    wout = fn(*wd, intra_dev)
    _ = np.asarray(wout[1])
    _ = np.asarray(compact_jit(wout[0], wout[1], cap)[0][:8])  # compile
    del warm, wd, wout

    # component: host decode only (entropy + IDCT, planes out)
    t0 = time.perf_counter()
    planes0 = src.planes(0, min(BATCH, n))
    t_decode_batch = time.perf_counter() - t0

    # component: upload only (async dispatch + block)
    padded0 = pad_planes_to_macroblocks(*planes0)
    up_bytes = sum(p.nbytes for p in padded0)
    t0 = time.perf_counter()
    dev = [jax.device_put(p) for p in padded0]
    for d in dev:
        d.block_until_ready()
    t_upload_batch = time.perf_counter() - t0

    out = bytearray()
    t_wait = [0.0]
    t_fetch = [0.0]
    t0 = time.perf_counter()
    pending = None  # (start, nframes, device result)

    def drain(p):
        start, k, res = p
        tw = time.perf_counter()
        bits = np.asarray(res[1])   # blocks until this batch's upload +
        tmid = time.perf_counter()  # encode finish (the pipeline wait)
        t_wait[0] += tmid - tw
        # then a device-side compaction so D2H carries ~stream bytes,
        # not the padded slice buffers (35 MB for a 2.3 MB stream)
        total_w = int(((bits + 31) // 32).sum())
        dense, _ = compact_jit(res[0], res[1], cap)
        # bucket the fetch length: a distinct slice shape per batch
        # would recompile the slice executable
        fetch_w = min(-(-total_w // 65536) * 65536, cap)
        rows = split_compact_slices(np.asarray(dense[:fetch_w]), bits)
        t_fetch[0] += time.perf_counter() - tmid
        out.extend(enc.assemble(rows, bits, W1080, H1080, start))

    for start, planes in src.plane_batches(BATCH):
        dev = [jax.device_put(p)
               for p in pad_planes_to_macroblocks(*planes)]  # async upload
        res = fn(*dev, intra_dev)                            # async dispatch
        if pending is not None:
            drain(pending)                                   # overlap host work
        pending = (start, planes[0].shape[0], res)
    drain(pending)
    out.extend(headers.sequence_end())
    wall = time.perf_counter() - t0
    shutil.rmtree(folder)
    # untimed validation: the stream must decode to every frame (our own
    # spec decoder); a failure here fails the run
    from ec504_imageencoder_tpu.models.decoder import decode_es_fast, psnr
    from ec504_imageencoder_tpu.ops.jpeg_tpu import decode_rgb_from_planes

    dec = decode_es_fast(bytes(out))
    if len(dec) != n:
        raise RuntimeError(f"stream decodes to {len(dec)} of {n} frames")
    src_rgb = decode_rgb_from_planes(*(p[0] for p in planes0), np)
    check = {
        "frames_decoded": len(dec),
        "psnr_frame0_db": round(float(psnr(src_rgb, dec[0])), 2),
    }
    return {
        "validation": check,
        "frames": n,
        "fps_end_to_end": n / wall,
        "wall_s": wall,
        "intake": "ycbcr420_planes",
        "decode_fps_host": len(planes0[0]) / t_decode_batch,
        "decode_s_per_batch": t_decode_batch,
        "upload_s_per_batch": t_upload_batch,
        "upload_mbytes_per_batch": round(up_bytes / 1e6, 1),
        "pipeline_wait_s_total": round(t_wait[0], 3),
        "fetch_s_total": round(t_fetch[0], 3),
        "stream_bytes": len(out),
    }


def main() -> None:
    import jax

    from chip_smoke import card_line
    from ec504_imageencoder_tpu.utils.compile_cache import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: {dev} (a CPU run is not a device number)")
    enable_compile_cache()
    power = card_line()
    _log(f"card: {power}")
    _log("building + timing reference C encoder")
    ref = measure_reference()
    _log(f"reference: {ref}")
    device = measure_device_1080p()
    e2e = {}
    if os.environ.get("EC504_BENCH_E2E", "1") == "1":
        _log("measuring end-to-end JPEG folder -> .mpeg")
        e2e = measure_end_to_end()
        _log(f"end_to_end: {e2e}")
    value = device["fps"]
    base = ref.get("fps_1080_equiv")
    vs = (value / base) if base else None
    print(json.dumps({
        "metric": "1080p intra encode frames/s (device pipeline)",
        "value": round(value, 3),
        "unit": "frames/s",
        "vs_baseline": round(vs, 1) if vs is not None else None,
        "device_kind": dev.device_kind,
        "card": power,
    }))
    # diagnostics on stderr so stdout stays a single JSON line
    print(json.dumps({"reference": ref, "device": device, "end_to_end": e2e}),
          file=sys.stderr)


if __name__ == "__main__":
    main()
