"""Device-side LZ77 sequence execution (M2).

The reference executes sequences one byte at a time
(decoding_context.rs:95-98).  The parallel formulation (SURVEY.md §5
"long-context" hard part): every output byte's origin is either a
literal or ``position - offset``; self-referential match chains
(overlaps, matches-of-matches) are resolved by **pointer doubling** —
O(log chain-depth) rounds of whole-buffer gathers — after which one
final gather materializes every byte from the literal pool
simultaneously.

The host precomputes the per-byte source map with NumPy interval
arithmetic (no Python per-byte loops); the device runs the doubling
rounds and the final materialization.

The engine's default executor is the native C one
(native/zstd_tpu_native.c, memcpy-chunked); this kernel is the
pure-device path (``DeviceEngine(device_execute=True)``), off by
default.  Its speed on a GPU is not measured yet.
"""

from __future__ import annotations

from functools import partial

import numpy as np

from ..ops.sequence_codes import resolve_offset


def _resolve_offsets(ll, ofv, rep: list[int]) -> np.ndarray:
    try:
        from .. import native

        have = native.available()
    except ImportError:
        have = False
    if have:
        from .. import native

        rep_arr = np.asarray(rep, dtype=np.uint64)
        offs = native.resolve_offsets(ll, ofv, rep_arr)  # ValueError on corrupt
        rep[:] = [int(r) for r in rep_arr]
        return offs
    return np.array(
        [resolve_offset(int(v), int(l), rep) for l, v in zip(ll, ofv)],
        dtype=np.int64,
    )


def build_source_map(
    ll,
    ofv,
    ml,
    n_literals: int,
    rep: list[int],
    out_base: int,
):
    """Per-byte source map for one block's execution.

    ``ll``/``ofv``/``ml`` are the block's decoded sequence arrays;
    ``out_base`` is the frame-output length before this block.  Returns
    (src int64[block_out], total) where ``src[j] < 0`` encodes literal
    ``-src[j] - 1`` and ``src[j] >= 0`` is an absolute frame-output
    position.  Mutates ``rep`` (the repeat-offset history).
    """
    if len(ll) == 0:
        src = -np.arange(1, n_literals + 1, dtype=np.int64)
        return src, n_literals

    ll = np.asarray(ll, dtype=np.int64)
    ml = np.asarray(ml, dtype=np.int64)
    # The repeat-offset scan is the cheap intrinsically-serial pass
    # (SURVEY.md §7 hard part #4); it stays host-side — in C when
    # available (1.5M-sequence frames cost seconds as a Python loop).
    offs = _resolve_offsets(ll, ofv, rep)
    trailing = n_literals - int(ll.sum())
    if trailing < 0:
        raise ValueError("literal runs exceed available literals")

    n = len(ll)
    seg_lens = np.empty(2 * n + 1, dtype=np.int64)
    seg_lens[0:-1:2] = ll
    seg_lens[1::2] = ml
    seg_lens[-1] = trailing
    starts = np.concatenate([[0], np.cumsum(seg_lens)])
    total = int(starts[-1])
    src = np.empty(total, dtype=np.int64)

    # Literal bytes (vectorized): byte k of the literal pool lands at
    # (its segment's start) + (k - literals consumed before the segment).
    lit_lens = np.concatenate([ll, [trailing]])
    lit_seg_starts = starts[0::2]
    lit_before = np.concatenate([[0], np.cumsum(ll)])
    delta = np.repeat(lit_seg_starts - lit_before, lit_lens)
    lit_pos = delta + np.arange(n_literals, dtype=np.int64)
    src[lit_pos] = -np.arange(n_literals, dtype=np.int64) - 1

    # Match bytes (vectorized): src = absolute position - offset.
    match_starts = starts[1 : 2 * n : 2]
    ml_before = np.concatenate([[0], np.cumsum(ml)])[:-1]
    mpos = np.repeat(match_starts - ml_before, ml) + np.arange(
        int(ml.sum()), dtype=np.int64
    )
    src[mpos] = out_base + mpos - np.repeat(offs, ml)
    return src, total


@partial(
    __import__("jax").jit,
    static_argnames=("rounds",),
)
def resolve_and_materialize(src, literals, *, rounds: int = 25):
    """Pointer-double ``src`` to literal origins, then materialize.

    ``src`` int32[T]: negative = literal index encoding, else an
    absolute output position (strictly less than its own).  Doubling
    runs in a ``while_loop`` that stops as soon as every byte has
    resolved to a literal — real streams' match chains are usually
    < 2^4 deep, so this typically runs a handful of the up-to-
    ``rounds`` iterations.  Returns uint8[T].
    """
    import jax
    import jax.numpy as jnp

    def cond(state):
        i, s = state
        return (i < rounds) & jnp.any(s >= 0)

    def body(state):
        i, s = state
        nxt = s[jnp.clip(s, 0)]
        return i + 1, jnp.where(s >= 0, nxt, s)

    _, src = jax.lax.while_loop(cond, body, (jnp.int32(0), src))
    return literals[jnp.clip(-src - 1, 0)]


def execute_frame_on_device(block_programs) -> bytes:
    """Execute a frame's blocks on device.

    ``block_programs``: list of (kind, payload) from the engine:
    ('bytes', nparray) for raw/RLE/literal-only blocks, or
    ('seq', (src_map, literals)) for sequence blocks.  Source maps use
    absolute frame positions, so all blocks concatenate into one device
    program: a single doubling pass resolves cross-block references.
    """
    import jax.numpy as jnp

    srcs = []
    lit_parts = []
    lit_off = 0
    out_len = 0
    for kind, payload in block_programs:
        if kind == "bytes":
            arr = np.asarray(payload, dtype=np.uint8)
            srcs.append(-(lit_off + np.arange(len(arr), dtype=np.int64)) - 1)
            lit_parts.append(arr)
            lit_off += len(arr)
            out_len += len(arr)
        else:
            src_map, lits = payload
            src_map = src_map.copy()
            src_map[src_map < 0] -= lit_off  # shift literal indices
            srcs.append(src_map)
            lit_parts.append(np.asarray(lits, dtype=np.uint8))
            lit_off += len(lit_parts[-1])
            out_len += len(src_map)

    if not srcs:
        return b""
    src = np.concatenate(srcs).astype(np.int64)
    literals = np.concatenate(lit_parts) if lit_parts else np.zeros(1, np.uint8)
    rounds = max(1, int(np.ceil(np.log2(max(2, len(src))))) + 1)
    out = resolve_and_materialize(
        jnp.asarray(src.astype(np.int32)),
        jnp.asarray(literals),
        rounds=rounds,
    )
    return np.asarray(out).tobytes()
