"""zstd_tpu — a ZSTD codec with a batched accelerator decoder (JAX /
XLA / Pallas-Triton).

Brand-new implementation of RFC 8878 with the capabilities of the
reference decompressor (AchilleBailly/zstd-decompressor), built around
a host-side parsing prepass, wide batched entropy-decode kernels,
chunked sequence execution, and mesh-sharded multi-device decode.  See
SURVEY.md for the layer map.

Layout:

* ``zstd_tpu.utils``    — bit cursors, xxh64, error taxonomy
* ``zstd_tpu.format``   — frame/block/section parsing (host prepass)
* ``zstd_tpu.ops``      — FSE/Huffman table builds, code tables, LZ77
* ``zstd_tpu.runtime``  — host oracle decoder, decoding context, engine
* ``zstd_tpu.kernels``  — device (Pallas-Triton/lax.scan) decode kernels
* ``zstd_tpu.parallel`` — mesh sharding, multi-host block dispatch
* ``zstd_tpu.testing``  — libzstd differential oracle (tests only)
"""

from .format.frame import MAX_WINDOW_SIZE
from .runtime.oracle import decode_frame, decompress
from .utils import errors

__version__ = "0.1.0"


def compress(data: bytes, level: int = 3, **kw) -> bytes:
    """Compress ``data`` into a ZSTD frame (see zstd_tpu.encode)."""
    from . import encode

    return encode.compress(data, level, **kw)


__all__ = [
    "MAX_WINDOW_SIZE",
    "compress",
    "decode_frame",
    "decompress",
    "errors",
    "__version__",
]
