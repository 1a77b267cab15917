"""Per-lane buffered backward-bitstream windows (lax.scan kernels).

The scan kernels never gather per *read*: each lane carries an
N*32-bit left-aligned bit buffer in the scan state and refills it one
u32 word at a time (one gather per ~2 decoded symbols), consuming bits
with elementwise shifts.  (The Triton kernels in triton_decode.py read
their bits straight from the words buffer instead.)

Buffer state is a tuple ``bs`` of N uint32 arrays (N chosen per kernel:
3 words for literals, 4 for sequences whose worst-case single read
burst is 90 bits) plus:

* ``nbits`` — valid bits currently buffered.  Phantom zero-padding past
  the stream start is allowed (refills past word 0 insert zeros but
  still count) — this reproduces the flat-table endgame's zero-padding
  semantics; real over-consumption is detected by the separate stream
  cursor going negative.
* ``wi``    — index of the next u32 word to load, counting *down*
  (backward streams consume their highest words first,
  SURVEY.md §7 hard part #1).

All helpers are mask-friendly: pass ``n = 0`` / ``enable=False`` for
inactive lanes; gathers are issued unconditionally (SIMD cost is
per-op) with clamped indices.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

U32 = jnp.uint32
# A *numpy* scalar, deliberately: ``jnp.uint32(0)`` at module scope
# eagerly creates a device array, and a jitted scan that captures such
# a concrete array closes over a device constant instead of a
# trace-time literal.  Only trace-time literals (numpy scalars / Python
# ints) may be captured by kernels.
_ZERO = np.uint32(0)


def _shl(v, n):
    """v << n for per-lane n in [0, 32]; 0 when n >= 32."""
    n = n.astype(U32)
    return jnp.where(n >= 32, _ZERO, v << jnp.minimum(n, U32(31)))


def _shr(v, n):
    """v >> n for per-lane n in [0, 32]; 0 when n >= 32."""
    n = n.astype(U32)
    return jnp.where(n >= 32, _ZERO, v >> jnp.minimum(n, U32(31)))


def _place(v, sh):
    """v shifted by signed per-lane sh (bits): << for sh>=0, >> for sh<0,
    zero outside (-32, 32)."""
    pos = jnp.maximum(sh, 0)
    neg = jnp.maximum(-sh, 0)
    return jnp.where(sh >= 0, _shl(v, pos), _shr(v, neg))


def buf_init(p0, nwords: int):
    """Empty buffer for lanes whose cursor starts at ``p0`` bits.

    Returns (bs, nbits, wi, top_bits).  Callers insert the sentinel-
    adjacent partial word with :func:`buf_insert_top`, then refill.
    """
    z = jnp.zeros_like(p0).astype(U32)
    bs = tuple(z for _ in range(nwords))
    nbits = jnp.zeros_like(p0)
    wi = (p0 >> 5).astype(jnp.int32)
    top_bits = (p0 & 31).astype(jnp.int32)
    return bs, nbits, wi, top_bits


def buf_insert_top(bs, nbits, wi, top_bits, words, base):
    """Insert the partial top word (buffer must be empty): one gather."""
    idx = jnp.maximum(base + wi, 0)
    v = words[idx]
    has = top_bits > 0
    mask = _shl(U32(1), top_bits.astype(U32)) - U32(1)
    v = jnp.where(has, v & mask, _ZERO)
    b0 = jnp.where(has, _shl(v, (U32(32) - top_bits.astype(U32))), bs[0])
    nbits = jnp.where(has, top_bits, nbits)
    # Word wi is consumed whether partial or (top_bits == 0) untouched-
    # but-aligned; the next full word is wi - 1 either way.
    return (b0,) + bs[1:], nbits, wi - 1


def buf_refill(bs, nbits, wi, words, base, enable=True):
    """Append one u32 word below the current contents (one gather).

    Fires for lanes with ``enable`` and room (nbits <= 32*(N-1)); lanes
    past the stream start append phantom zeros (still counted — see
    module docstring).
    """
    n = len(bs)
    idx = jnp.maximum(base + wi, 0)
    v = jnp.where(wi >= 0, words[idx], _ZERO)
    do = enable & (nbits <= 32 * (n - 1))
    v = jnp.where(do, v, _ZERO)
    out = tuple(
        bs[j] | _place(v, 32 * j - nbits) for j in range(n)
    )
    nbits = jnp.where(do, nbits + 32, nbits)
    wi = jnp.where(do, wi - 1, wi)
    return out, nbits, wi


def buf_peek(bs, n_static: int):
    """Top ``n_static`` (<= 32, Python int) bits of the buffer."""
    return bs[0] >> U32(32 - n_static)


def buf_consume(bs, nbits, n):
    """Drop the top ``n`` bits (per-lane, 0 <= n <= 32)."""
    nw = len(bs)
    n32 = n.astype(U32)
    out = []
    for j in range(nw):
        hi = _shl(bs[j], n32) | jnp.where(
            n32 >= 32, (bs[j + 1] if j + 1 < nw else _ZERO), _ZERO
        )
        lo = _shr(bs[j + 1], U32(32) - n32) if j + 1 < nw else _ZERO
        out.append(hi | lo)
    return tuple(out), nbits - n.astype(nbits.dtype)


def buf_take(bs, nbits, n):
    """Read the top ``n`` bits (0 <= n <= 31) as a value and consume."""
    n32 = n.astype(U32)
    top = bs[0] >> U32(1)  # keep bit 31 free so n == 31 is safe
    val = _shr(top, U32(31) - n32)
    bs, nbits = buf_consume(bs, nbits, n)
    return val, bs, nbits
