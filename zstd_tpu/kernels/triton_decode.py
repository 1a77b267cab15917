"""Batched entropy decode as Pallas-Triton kernels for NVIDIA GPUs.

One launch per phase.  The grid runs over blocks of ``LANE_BLOCK``
lanes; each lane is one element of the block's vectors, so it runs its
whole decode loop in registers, and the block loops to the largest
work among its own lanes (``blk_steps``; the engine sorts lanes by
descending work so a block's lanes finish together).

The lax.scan forms in ``entropy2.py`` carry a bit buffer and select
table rows with one-hot compare-and-reduce; here every access is a
per-lane indexed load instead:

* **Bit reads** load the one or two u32 words that hold the field
  straight from the plan-resident ``words`` buffer.  There is no buffer
  to refill and no window cap, so any lane can take this path.  Words
  below a stream's base read as zeros, the same phantom zero-padding as
  ``bitbuf``.
* **Huffman lookups** read a flat 2^11-entry table per Huffman slot
  (``huffman_flat``: ``symbol | length << 8``), one load per symbol.
* **FSE lookups** read ``fse_flat0/1[fse_off[slot] + state]``.

Outputs keep the dense contracts of ``decode_literals_dense`` and
``decode_sequences_dense``: one ``uint32[n_dense + L]`` array per call,
lane j's words at ``cum[j]`` (literals, 4 symbols per word) or
``cumw[j] + i * g`` (sequences, word-packed triples), then the per-lane
ok flags.  The overflow flags match the scan form, so the engine's wide
retry still catches ll or ml > 0xFFFF and offset codes >= 31.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from .entropy2 import LIT_LANE_COLS, SEQ_LANE_COLS

U32 = jnp.uint32
LANE_BLOCK = 16  # lanes per program (a power of two, as Triton needs)
HUFF_FLAT = 1 << 11  # entries per flat Huffman table (max code length 11)


def huffman_flat(limits, prevs, lengths, rankb, ranked) -> np.ndarray:
    """Flat decode tables from the canonical class arrays.

    (T, 12) class arrays and (T, 256) ``ranked`` -> int32[T, 2048] with
    entry ``symbol | length << 8`` for every 11-bit window.  Mirrors the
    scan form's class find and ranked select exactly, including its
    zero results for windows no class covers."""
    t = limits.shape[0]
    pad = lambda a: np.concatenate([a, np.zeros((t, 1), a.dtype)], 1)  # noqa: E731
    v = np.arange(HUFF_FLAT, dtype=np.int64)[None, :]
    j = (v[:, :, None] >= limits[:, None, :]).sum(-1)
    length = np.take_along_axis(pad(lengths), j, 1).astype(np.int64)
    prev = np.take_along_axis(pad(prevs), j, 1)
    rank = np.take_along_axis(pad(rankb), j, 1) + ((v - prev) >> (11 - length))
    inside = (rank >= 0) & (rank < 256)
    sym = np.take_along_axis(ranked, np.clip(rank, 0, 255), 1)
    sym = np.where(inside, sym, 0) & 0xFF
    return (sym | (length << 8)).astype(np.int32)


def _shl(v, n):
    """v << n for per-lane n >= 0 (uint32); 0 when n >= 32."""
    n = n.astype(U32)
    return jnp.where(n >= 32, U32(0), v << (n & U32(31)))


def _shr(v, n):
    n = n.astype(U32)
    return jnp.where(n >= 32, U32(0), v >> (n & U32(31)))


def _load(ref, idx, mask):
    return plt.load(ref.at[jnp.maximum(idx, 0)], mask=mask, other=0)


def _bits(words_ref, base, pos, n):
    """Bits [pos - n, pos) of each lane's backward stream, MSB-first.

    ``pos`` counts bits from the lane's base word; n <= 31.  Words
    below the base read as zeros."""
    q = pos - n
    wq = q >> 5
    off = (q & 31).astype(U32)
    w0 = _load(words_ref, base + wq, wq >= 0)
    two = (off + n.astype(U32) > 32) & (wq >= -1)
    w1 = _load(words_ref, base + wq + 1, two)
    v = (w0 >> off) | _shl(w1, U32(32) - off)
    return v & ((U32(1) << n.astype(U32)) - U32(1))


def _block_rows():
    return pl.program_id(0) * LANE_BLOCK + jnp.arange(LANE_BLOCK, dtype=jnp.int32)


def _lit_kernel(words_ref, lanes_ref, cum_ref, steps_ref, flat_ref, out_ref, *, n_dense):
    rows = _block_rows()
    col = lambda c: lanes_ref[c, pl.ds(pl.program_id(0) * LANE_BLOCK, LANE_BLOCK)]  # noqa: E731
    base, p0, pend, regen, slot = (col(c) for c in range(LIT_LANE_COLS))
    toff = slot * HUFF_FLAT
    dst = cum_ref[pl.ds(pl.program_id(0) * LANE_BLOCK, LANE_BLOCK)]
    nwords = (regen + 3) >> 2
    eleven = jnp.full((LANE_BLOCK,), 11, jnp.int32)

    def body(t, pos):
        word = jnp.zeros((LANE_BLOCK,), U32)
        for k in range(4):
            active = 4 * t + k < regen
            e = plt.load(flat_ref.at[toff + _bits(words_ref, base, pos, eleven).astype(jnp.int32)])
            pos = pos - jnp.where(active, e >> 8, 0)
            word = word | ((e & 0xFF).astype(U32) << U32(8 * k))
        plt.store(out_ref.at[dst + t], word, mask=t < nwords)
        return pos

    pos = jax.lax.fori_loop(0, steps_ref[pl.program_id(0)], body, p0)
    out_ref[n_dense + rows] = (pos == pend).astype(U32)


@partial(jax.jit, static_argnames=("n_dense", "interpret"))
def decode_literals_gpu(
    words,  # uint32[W] plan-resident input words
    lanes,  # int32[LIT_LANE_COLS, L] per-lane columns (entropy2.LIT_LANE_COLS)
    cum,  # int32[L + 1] word-count prefix sums (ceil(regen / 4))
    blk_steps,  # int32[L / LANE_BLOCK] words to decode per lane block
    flat,  # int32[T * 2048] flat Huffman tables (huffman_flat)
    *,
    n_dense: int,
    interpret: bool = False,
):
    """Decode L Huffman streams; returns uint32[n_dense + L] (lane j's
    packed symbols at cum[j] words, then ok flags)."""
    L = lanes.shape[1]
    return pl.pallas_call(
        partial(_lit_kernel, n_dense=n_dense),
        out_shape=jax.ShapeDtypeStruct((n_dense + L,), U32),
        grid=(L // LANE_BLOCK,),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="zt_literals",
    )(words, lanes, cum, blk_steps, flat)


def _seq_kernel(
    words_ref, lanes_ref, cumw_ref, steps_ref, flat0_ref, flat1_ref, off_ref,
    out_ref, *, n_dense_w,
):
    rows = _block_rows()
    start = pl.program_id(0) * LANE_BLOCK
    col = lambda c: lanes_ref[c, pl.ds(start, LANE_BLOCK)]  # noqa: E731
    (
        base, p0, pend, nseq, w_ll, w_ml, w_of,
        ll_slot, of_slot, ml_slot, ll_al, of_al, ml_al,
    ) = (col(c) for c in range(SEQ_LANE_COLS))
    dst = cumw_ref[pl.ds(start, LANE_BLOCK)]
    two = (w_ll + w_ml + w_of) > 32
    g = 1 + two.astype(jnp.int32)
    o_ll, o_of, o_ml = (off_ref[s] for s in (ll_slot, of_slot, ml_slot))
    s_ml_sh = w_ll.astype(U32)
    s_of_sh = s_ml_sh + w_ml.astype(U32)

    # tANS state init: LL, OF, ML order (sequence.rs:59-65).
    pos = p0
    s_ll = _bits(words_ref, base, pos, ll_al).astype(jnp.int32)
    pos = pos - ll_al
    s_of = _bits(words_ref, base, pos, of_al).astype(jnp.int32)
    pos = pos - of_al
    s_ml = _bits(words_ref, base, pos, ml_al).astype(jnp.int32)
    pos = pos - ml_al

    def take(pos, n):
        return _bits(words_ref, base, pos, n), pos - n

    def body(i, carry):
        pos, s_ll, s_of, s_ml, bad = carry
        active = i < nseq
        e0_ll, e1_ll = flat0_ref[o_ll + s_ll], flat1_ref[o_ll + s_ll]
        e0_of, of_code = flat0_ref[o_of + s_of], flat1_ref[o_of + s_of]
        e0_ml, e1_ml = flat0_ref[o_ml + s_ml], flat1_ref[o_ml + s_ml]

        # Extra bits: OF, ML, LL (sequence.rs:50-52).
        v, pos = take(pos, jnp.where(active, of_code, 0))
        ofv = (U32(1) << of_code.astype(U32)) + v
        v, pos = take(pos, jnp.where(active, e1_ml & 31, 0))
        ml = (e1_ml >> 5) + v.astype(jnp.int32)
        v, pos = take(pos, jnp.where(active, e1_ll & 31, 0))
        ll = (e1_ll >> 5) + v.astype(jnp.int32)

        # State updates LL, ML, OF, skipped on the last sequence.
        upd = active & (i < nseq - 1)
        v, pos = take(pos, jnp.where(upd, e0_ll & 0xFFFF, 0))
        s_ll = jnp.where(upd, (e0_ll >> 16) + v.astype(jnp.int32), s_ll)
        v, pos = take(pos, jnp.where(upd, e0_ml & 0xFFFF, 0))
        s_ml = jnp.where(upd, (e0_ml >> 16) + v.astype(jnp.int32), s_ml)
        v, pos = take(pos, jnp.where(upd, e0_of & 0xFFFF, 0))
        s_of = jnp.where(upd, (e0_of >> 16) + v.astype(jnp.int32), s_of)

        # Narrow field ranges as in the scan form's (pa, pb) planes; a
        # value past its range or its packed width flags the lane.
        ofv31 = ofv & U32(0x7FFFFFFF)
        ll16 = ll.astype(U32) & U32(0xFFFF)
        ml16 = ml.astype(U32) & U32(0xFFFF)
        over = (
            (of_code >= 31) | (ll > 0xFFFF) | (ml > 0xFFFF)
            | (_shr(ll16, w_ll) != 0) | (_shr(ml16, w_ml) != 0)
            | (_shr(ofv31, w_of) != 0)
        )
        bad = bad | (active & over)
        lo = ll16 | _shl(ml16, s_ml_sh) | _shl(ofv31, s_of_sh)
        hi = _shr(ml16, U32(32) - s_ml_sh) | jnp.where(
            s_of_sh >= 32,
            _shl(ofv31, s_of_sh - U32(32)),
            _shr(ofv31, U32(32) - s_of_sh),
        )
        at = dst + i * g
        plt.store(out_ref.at[at], lo, mask=active)
        plt.store(out_ref.at[at + 1], hi, mask=active & two)
        return pos, s_ll, s_of, s_ml, bad

    carry = (pos, s_ll, s_of, s_ml, jnp.zeros((LANE_BLOCK,), jnp.bool_))
    pos, _, _, _, bad = jax.lax.fori_loop(
        0, steps_ref[pl.program_id(0)], body, carry
    )
    out_ref[n_dense_w + rows] = ((pos == pend) & ~bad).astype(U32)


@partial(jax.jit, static_argnames=("n_dense_w", "interpret"))
def decode_sequences_gpu(
    words,  # uint32[W]
    lanes,  # int32[SEQ_LANE_COLS, L] per-lane columns (entropy2.SEQ_LANE_COLS)
    cumw,  # int32[L + 1] prefix sums of per-lane packed word counts
    blk_steps,  # int32[L / LANE_BLOCK] sequences to decode per lane block
    flat0,  # int32[N] FSE bank planes (see decode_sequences_dense)
    flat1,
    fse_off,  # int32[S] first row of each slot
    *,
    n_dense_w: int,
    interpret: bool = False,
):
    """Decode L interleaved-tANS sequence streams; returns
    uint32[n_dense_w + L] (word-packed triples, then ok flags)."""
    L = lanes.shape[1]
    return pl.pallas_call(
        partial(_seq_kernel, n_dense_w=n_dense_w),
        out_shape=jax.ShapeDtypeStruct((n_dense_w + L,), U32),
        grid=(L // LANE_BLOCK,),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="zt_sequences",
    )(words, lanes, cumw, blk_steps, flat0, flat1, fse_off)
