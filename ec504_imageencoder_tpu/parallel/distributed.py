"""Multi-host distributed encoding.

jax.distributed + the workload's natural decomposition (SURVEY.md §2.1):
GOPs are fully independent byte segments, so hosts take GOPs round-robin,
write checkpointed segment files (runtime/checkpoint.py), synchronize
with a device barrier, and process 0 stitches the final stream.  Within
a host, the sharded encoder fans frames/rows across the local devices
(a flat device list; slices need no device-to-device traffic); the only
cross-host traffic is the file-system segment gather, mirroring how
slices/GOPs are byte-aligned islands.

Failure model: frames are independent — a lost host's pending GOPs are
simply absent from the manifest, and any restart (same workdir) encodes
exactly the missing ones.  `encode_multihost` therefore doubles as the
fault re-dispatch path.
"""

from __future__ import annotations

import os
import time

import numpy as np

import jax

from ec504_imageencoder_tpu.models.mpeg1 import MPEG1IntraEncoder
from ec504_imageencoder_tpu.runtime.checkpoint import CheckpointedEncode
from ec504_imageencoder_tpu.syntax import headers


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> tuple[int, int]:
    """Initialize jax.distributed (env-driven when args are None).

    Returns (process_id, num_processes).  Safe to call in single-process
    mode (returns (0, 1) without initializing).
    """
    if num_processes in (None, 1) and not coordinator_address and not os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    ):
        return 0, 1
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return jax.process_index(), jax.process_count()


def barrier(name: str) -> None:
    """Cross-process barrier over the global device set."""
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices(name)


def encode_multihost(
    frame_source,
    total_frames: int,
    workdir: str,
    out_path: str,
    encoder: MPEG1IntraEncoder | None = None,
) -> int | None:
    """Encode across all processes; returns stream size on process 0.

    Each process encodes GOPs g with g % process_count == process_index
    into the shared `workdir` (its own manifest file avoids write races),
    then process 0 stitches every segment.
    """
    pid, nproc = jax.process_index(), jax.process_count()
    enc = encoder or MPEG1IntraEncoder()
    sess = CheckpointedEncode(
        workdir, enc, total_frames
    )
    sess.manifest_path = os.path.join(workdir, f"manifest_{pid}.json")
    sess.segments = {}
    sess._load_manifest()

    for g in range(sess.n_gops()):
        if g % nproc != pid or g in sess.segments:
            continue
        start, end = sess.gop_frame_range(g)
        sess.encode_gop(g, frame_source(start, end))

    barrier("encode_complete")

    if pid != 0:
        return None

    # stitch: trust segment files named by GOP index; verify count
    total = 0
    with open(out_path, "wb") as out:
        for g in range(sess.n_gops()):
            path = os.path.join(workdir, f"seg_{g:06d}.m1vseg")
            deadline = time.time() + 30.0  # shared-fs visibility grace
            while not os.path.exists(path) and time.time() < deadline:
                time.sleep(0.2)
            if not os.path.exists(path):
                raise RuntimeError(f"missing segment for GOP {g}: {path}")
            with open(path, "rb") as f:
                total += out.write(f.read())
        total += out.write(headers.sequence_end())
    return total
