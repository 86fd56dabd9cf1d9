"""MPEG-1 intra-frame video encoder on JAX/XLA.

Built from scratch with the full capabilities of the reference C encoder
(eburhansjah/ec504_ImageEncoder) plus an ISO-compliant production mode.
See README.md and PARITY.md.
"""

from ec504_imageencoder_tpu.api import encode_video, mpeg_encode_procedure

__all__ = ["encode_video", "mpeg_encode_procedure"]
__version__ = "0.1.0"
