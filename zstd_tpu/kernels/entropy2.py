"""Batched entropy decode as lax.scan loops (plain XLA, any backend).

The engine runs these forms on the CPU and under a device mesh; on a
GPU it runs the Triton kernels (triton_decode.py), which are tested
against these.  The design avoids per-read gathers and table gathers,
which an earlier accelerator executed serially:

* **Buffered bit reads** — one u32 refill gather per ~2 symbols via the
  per-lane N-word window (kernels/bitbuf.py) instead of 2 gathers per
  read.  Literals carry 96 bits; sequences carry 128 (their worst-case
  single-sequence burst is 90 bits, and refill needs 32 bits of room —
  a 96-bit buffer would deadlock in the (64, 90) occupancy window).
* **No table gathers** — the host pre-gathers each lane's table rows
  ((L, 12)/(L, 256) canonical-Huffman arrays, (L, 512) FSE planes);
  in-kernel lookups are compare-iota + select-reduce, elementwise.
* **Arithmetic canonical Huffman** — code length from 12 boundary
  compares in the 11-bit window space, then a ranked-symbol select;
  no 2048-entry LUT.
* **Value tables folded into FSE entries** — each state's packed planes
  carry (baseline, nbits) and (value_base, value_extra_bits); symbol
  range checks moved to pack time, and state updates stay in-range by
  the decode-table tiling invariant, so the kernel needs no checks.
* **Tile-aligned chunked emission** — literals emit (8, L) u32 rows of
  32 packed symbols per scan step; sequences emit (8, L) rows of 8
  sequence slots with a validity plane (a lane stalls a slot when its
  window holds < 90 bits; the host compacts valid slots in order).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .bitbuf import (
    buf_consume,
    buf_init,
    buf_insert_top,
    buf_peek,
    buf_refill,
    buf_take,
)

U32 = jnp.uint32

LIT_SYMS_PER_STEP = 32
LIT_BUF_WORDS = 3
SEQ_SLOTS_PER_STEP = 8
SEQ_BUF_WORDS = 6
SEQ_MAX_BITS = 90  # of extra <= 31, ml/ll extra <= 16, 3 updates <= 9 each

# Never-stall invariant: each sequence slot refills 3 words (96 bits of
# inflow, phantom zeros past the stream start) against a worst-case
# outflow of SEQ_MAX_BITS = 90, and the 6-word (192-bit) buffer always
# has room for the inflow after any legal consume — so ``nbits >= 96``
# holds before every sequence and a slot never stalls.  Step counts are
# therefore exact (ceil(nseq / SEQ_SLOTS_PER_STEP)) and slot validity
# is a pure per-lane prefix.


def _dense_indices(cum, n_dense: int, n_lanes: int):
    """Flat gather indices compacting per-lane prefixes into one array.

    ``cum`` is int32[L + 1] (cum[j]..cum[j+1] = lane j's dense range).
    Element ``i`` of the dense output maps to source element
    ``(i - cum[lane]) * L + lane`` of a row-major (rows, L) plane —
    lane attribution is a scatter of L boundary marks + cumsum, never a
    per-element search.  Positions past cum[-1] are padding (clipped
    gathers, garbage values the host never reads).
    """
    marks = jnp.zeros(n_dense, jnp.int32).at[cum[1:]].add(1, mode="drop")
    lane = jnp.cumsum(marks)
    start = jnp.take(cum, lane, mode="clip")
    k = jax.lax.iota(jnp.int32, n_dense) - start
    return k * n_lanes + lane


def _compact(plane, cum, n_dense: int):
    """Gather each lane's first cum[j+1]-cum[j] rows of a
    (steps, slots, L) plane into a dense 1-D array (see module note on
    the never-stall prefix invariant)."""
    n_lanes = plane.shape[-1]
    idx = _dense_indices(cum, n_dense, n_lanes)
    return jnp.take(plane.reshape(-1), idx, mode="clip")


def _shl32(v, n):
    """v << n for per-lane n >= 0; 0 when n >= 32 (v uint32)."""
    n = n.astype(U32)
    return jnp.where(n >= 32, U32(0), v << (n & U32(31)))


def _shr32(v, n):
    n = n.astype(U32)
    return jnp.where(n >= 32, U32(0), v >> (n & U32(31)))


def _pack_words(pa, pb, w_ll, w_ml, w_of):
    """Field-pack sequence triples: (lo, hi, lane_overflow).

    ``v = ll | ml << w_ll | ofv << (w_ll + w_ml)`` split into its low
    and high u32 words per slot.  A value exceeding its field width
    (possible only on corrupt input, e.g. an offset past the window)
    flags the lane so it re-decodes on the wide path — packing never
    silently truncates.  pa, pb: (R, L) narrow planes flattened from
    (steps, slots, L) (see decode_sequences_v2)."""
    valid = pa >> U32(31)
    ofv = jnp.where(valid != 0, pa & U32(0x7FFFFFFF), U32(0))
    ll = pb >> U32(16)
    ml = pb & U32(0xFFFF)

    wl = w_ll.astype(U32)[None, :]
    s_ml = wl
    s_of = wl + w_ml.astype(U32)[None, :]
    lo = ll | _shl32(ml, s_ml) | _shl32(ofv, s_of)
    hi = _shr32(ml, U32(32) - s_ml) | jnp.where(
        s_of >= 32, _shl32(ofv, s_of - U32(32)), _shr32(ofv, U32(32) - s_of)
    )
    over = (
        (_shr32(ll, wl) != 0)
        | (_shr32(ml, w_ml.astype(U32)[None, :]) != 0)
        | (_shr32(ofv, w_of.astype(U32)[None, :]) != 0)
    ) & (valid != 0)
    return lo, hi, jnp.any(over, axis=0)


def _pack_triples(pa, pb, w_ll, w_ml, w_of, nseq, cumw, n_dense_w: int):
    """Word-granular pack + gather compaction (XLA form).

    Each lane's sequence k occupies exactly ``g`` whole u32 words
    (g = 1 when the lane's field-width sum w = w_ll + w_ml + w_of is
    <= 32, else 2), so compaction is ONE data-dependent gather.  The
    Triton sequences kernel writes the same layout directly.

    cumw: int32[L+1] prefix sums of per-lane word counts nseq * g.
    Returns (packed uint32[n_dense_w], lane_overflow bool[L]).
    """
    R = pa.shape[0] * pa.shape[1]
    L = pa.shape[2]
    lo, hi, lane_over = _pack_words(
        pa.reshape(R, L), pb.reshape(R, L), w_ll, w_ml, w_of
    )
    # Interleave lo/hi as rows 2s / 2s+1 so one gather serves both
    # granules: dense word m of lane j is sequence k = (m - cumw[j]),
    # s = k >> gsh, granule k & gsh (gsh = g - 1 in {0, 1}).
    loihi = jnp.stack([lo, hi], axis=1).reshape(2 * R, L)
    gsh = ((w_ll + w_ml + w_of) > 32).astype(jnp.int32)
    marks = jnp.zeros(n_dense_w, jnp.int32).at[cumw[1:]].add(1, mode="drop")
    lane = jnp.cumsum(marks)
    k = jax.lax.iota(jnp.int32, n_dense_w) - jnp.take(cumw, lane, mode="clip")
    gl = jnp.take(gsh, lane, mode="clip")
    idx = ((k >> gl) * 2 + (k & gl)) * L + lane
    packed = jnp.take(loihi.reshape(-1), jnp.clip(idx, 0, 2 * R * L - 1))
    return packed, lane_over


def _literals_scan(
    words,
    base,
    p0,
    pend,
    regen,
    limits,
    prevs,
    lengths,
    rankb,
    ranked,
    max_steps: int,
):
    """Shared literals scan: (packed uint32[max_steps, 8, L], ok[L])."""
    iota12 = jax.lax.broadcasted_iota(jnp.int32, (1, 12), 1)
    iota256 = jax.lax.broadcasted_iota(jnp.int32, (1, 256), 1)

    bs, nbits, wi, top_bits = buf_init(p0, LIT_BUF_WORDS)
    bs, nbits, wi = buf_insert_top(bs, nbits, wi, top_bits, words, base)
    for _ in range(2):
        bs, nbits, wi = buf_refill(bs, nbits, wi, words, base)
    pos = p0

    def body(carry, t):
        bs, nbits, wi, pos = carry
        syms = []
        for g in range(LIT_SYMS_PER_STEP // 2):
            bs, nbits, wi = buf_refill(bs, nbits, wi, words, base)
            for k in range(2):
                i_sym = t * LIT_SYMS_PER_STEP + (2 * g + k)
                active = i_sym < regen
                v = buf_peek(bs, 11).astype(jnp.int32)
                j = jnp.sum((v[:, None] >= limits).astype(jnp.int32), axis=1)
                m12 = iota12 == j[:, None]
                length = jnp.sum(jnp.where(m12, lengths, 0), axis=1)
                prev = jnp.sum(jnp.where(m12, prevs, 0), axis=1)
                rb = jnp.sum(jnp.where(m12, rankb, 0), axis=1)
                rank = rb + ((v - prev) >> (11 - length))
                m256 = iota256 == rank[:, None]
                sym = jnp.sum(jnp.where(m256, ranked, 0), axis=1).astype(U32)
                n = jnp.where(active, length, 0)
                bs, nbits = buf_consume(bs, nbits, n)
                pos = pos - n
                syms.append(sym & U32(0xFF))
        rows = [
            syms[4 * r]
            | (syms[4 * r + 1] << U32(8))
            | (syms[4 * r + 2] << U32(16))
            | (syms[4 * r + 3] << U32(24))
            for r in range(8)
        ]
        return (bs, nbits, wi, pos), jnp.stack(rows)

    (bs, nbits, wi, pos), ys = jax.lax.scan(
        body, (bs, nbits, wi, pos), jnp.arange(max_steps, dtype=jnp.int32)
    )
    # Absolute indexing: streams live in place in the raw input, so a
    # lane ends at its byte offset's bit position, not 0 (block_table
    # _StreamLocator).
    ok = pos == pend
    return ys, ok


@partial(jax.jit, static_argnames=("max_steps",))
def decode_literals_v2(
    words,  # uint32[W]
    base,  # int32[L]
    p0,  # int32[L]
    pend,  # int32[L] end bit position (stream byte misalignment)
    regen,  # int32[L]
    limits,  # int32[L, 12]  class end boundaries in 11-bit window space
    prevs,  # int32[L, 12]  class start boundaries
    lengths,  # int32[L, 12]  code length per class
    rankb,  # int32[L, 12]  first symbol rank per class
    ranked,  # int32[L, 256] symbol value by rank
    *,
    max_steps: int,
):
    """Decode L huffman streams, 32 symbols per lane per step.

    Returns (packed uint32[max_steps, 8, L] — row r of a step holds
    symbols 4r..4r+3 LSB-first — and ok bool[L]).
    """
    return _literals_scan(
        words, base, p0, pend, regen,
        limits, prevs, lengths, rankb, ranked, max_steps,
    )


LIT_LANE_COLS = 5  # lane_mat columns: base, p0, pend, regen, slot


@partial(jax.jit, static_argnames=("max_steps", "n_dense"))
def decode_literals_dense(
    words,
    lane_mat,  # int32[L, 5] stacked per-lane columns (LIT_LANE_COLS):
    #            base word, p0 sentinel bitpos, pend end bitpos, regen,
    #            Huffman table slot — ONE upload per call instead of 5
    cum,  # int32[L + 1] word-count prefix sums (ceil(regen / 4))
    b_limits,  # int32[T, 12] table BANKS, uploaded once per plan —
    b_prevs,  # per-lane rows are gathered here on-device instead of
    b_lengths,  # being host-gathered and re-uploaded per call
    b_rankb,
    b_ranked,  # int32[T, 256]
    *,
    max_steps: int,
    n_dense: int,
):
    """Literals decode with on-device compaction: returns
    (dense uint32[n_dense] — lane j's packed words at cum[j]..cum[j+1],
    ok bool[L]).  The fetch then moves only real symbols, not the
    (steps, lanes) padding."""
    base, p0, pend, regen, slots = (lane_mat[:, c] for c in range(LIT_LANE_COLS))
    row = lambda b: jnp.take(b, slots, axis=0)  # noqa: E731
    ys, ok = _literals_scan(
        words, base, p0, pend, regen,
        row(b_limits), row(b_prevs), row(b_lengths), row(b_rankb),
        row(b_ranked), max_steps,
    )
    # One output array per call: dense words then per-lane ok flags, so
    # each call costs one device-to-host transfer.
    return jnp.concatenate([_compact(ys, cum, n_dense), ok.astype(U32)])



def _sequences_scan(
    words,
    base,
    p0,
    pend,
    nseq,
    ll_p0,
    ll_p1,
    of_p0,
    of_p1,
    ml_p0,
    ml_p1,
    ll_al,
    of_al,
    ml_al,
    max_steps: int,
    wide: bool,
):
    """Shared interleaved-tANS sequence scan (see decode_sequences_v2)."""
    iota512 = jax.lax.broadcasted_iota(jnp.int32, (1, 512), 1)

    bs, nbits, wi, top_bits = buf_init(p0, SEQ_BUF_WORDS)
    bs, nbits, wi = buf_insert_top(bs, nbits, wi, top_bits, words, base)
    for _ in range(5):
        bs, nbits, wi = buf_refill(bs, nbits, wi, words, base)
    pos = p0

    # State init: LL, OF, ML order (sequence.rs:59-65).
    v, bs, nbits = buf_take(bs, nbits, ll_al)
    s_ll = v.astype(jnp.int32)
    pos = pos - ll_al
    v, bs, nbits = buf_take(bs, nbits, of_al)
    s_of = v.astype(jnp.int32)
    pos = pos - of_al
    v, bs, nbits = buf_take(bs, nbits, ml_al)
    s_ml = v.astype(jnp.int32)
    pos = pos - ml_al

    emitted0 = jnp.zeros_like(nseq)
    bad0 = jnp.zeros(nseq.shape, bool)

    def rowsel(rows, mask):
        return jnp.sum(jnp.where(mask, rows, 0), axis=1)

    def body(carry, t):
        bs, nbits, wi, pos, s_ll, s_of, s_ml, emitted, bad = carry
        out_a, out_b, out_c = [], [], []
        for _slot in range(SEQ_SLOTS_PER_STEP):
            for _ in range(3):
                bs, nbits, wi = buf_refill(bs, nbits, wi, words, base)
            active = emitted < nseq
            can = active & (nbits >= SEQ_MAX_BITS)

            m_ll = iota512 == s_ll[:, None]
            m_of = iota512 == s_of[:, None]
            m_ml = iota512 == s_ml[:, None]
            e0_ll = rowsel(ll_p0, m_ll)
            e1_ll = rowsel(ll_p1, m_ll)
            e0_of = rowsel(of_p0, m_of)
            of_code = rowsel(of_p1, m_of)
            e0_ml = rowsel(ml_p0, m_ml)
            e1_ml = rowsel(ml_p1, m_ml)

            # Extra bits: OF, ML, LL (sequence.rs:50-52).
            n = jnp.where(can, of_code, 0)
            v, bs, nbits = buf_take(bs, nbits, n)
            pos = pos - n
            ofv = (U32(1) << of_code.astype(U32)) + v
            n = jnp.where(can, e1_ml & 31, 0)
            v, bs, nbits = buf_take(bs, nbits, n)
            pos = pos - n
            ml = (e1_ml >> 5) + v.astype(jnp.int32)
            n = jnp.where(can, e1_ll & 31, 0)
            v, bs, nbits = buf_take(bs, nbits, n)
            pos = pos - n
            ll = (e1_ll >> 5) + v.astype(jnp.int32)

            # State updates LL, ML, OF, skipped on the last sequence.
            upd = can & (emitted < nseq - 1)
            n = jnp.where(upd, e0_ll & 0xFFFF, 0)
            v, bs, nbits = buf_take(bs, nbits, n)
            pos = pos - n
            s_ll = jnp.where(upd, (e0_ll >> 16) + v.astype(jnp.int32), s_ll)
            n = jnp.where(upd, e0_ml & 0xFFFF, 0)
            v, bs, nbits = buf_take(bs, nbits, n)
            pos = pos - n
            s_ml = jnp.where(upd, (e0_ml >> 16) + v.astype(jnp.int32), s_ml)
            n = jnp.where(upd, e0_of & 0xFFFF, 0)
            v, bs, nbits = buf_take(bs, nbits, n)
            pos = pos - n
            s_of = jnp.where(upd, (e0_of >> 16) + v.astype(jnp.int32), s_of)

            emitted = emitted + can.astype(jnp.int32)
            pa = (can.astype(U32) << U32(31)) | (ofv & U32(0x7FFFFFFF))
            bad = bad | (can & (of_code >= 31))
            out_a.append(pa)
            if wide:
                out_b.append(jnp.where(can, ll, 0))
                out_c.append(jnp.where(can, ml, 0))
            else:
                # The narrow path's dense compaction assumes slot
                # validity is a per-lane PREFIX (never-stall invariant,
                # module note).  Enforce it: a stall (active but not
                # enough buffered bits) flags the lane so it routes to
                # the wide retry instead of silently shipping shifted
                # triples.
                bad = bad | (active & ~can)
                bad = bad | (can & ((ll > 0xFFFF) | (ml > 0xFFFF)))
                pb = (ll.astype(U32) << U32(16)) | (ml.astype(U32) & U32(0xFFFF))
                out_b.append(jnp.where(can, pb, U32(0)))

        ys = tuple(
            jnp.stack(o) for o in ((out_a, out_b, out_c) if wide else (out_a, out_b))
        )
        return (bs, nbits, wi, pos, s_ll, s_of, s_ml, emitted, bad), ys

    carry0 = (bs, nbits, wi, pos, s_ll, s_of, s_ml, emitted0, bad0)
    carry, planes = jax.lax.scan(
        body, carry0, jnp.arange(max_steps, dtype=jnp.int32)
    )
    pos, emitted, bad = carry[3], carry[7], carry[8]
    ok = (emitted == nseq) & (pos == pend) & ~bad
    return (*planes, ok)


@partial(jax.jit, static_argnames=("max_steps", "wide"))
def decode_sequences_v2(
    words,  # uint32[W]
    base,  # int32[L]
    p0,  # int32[L]
    pend,  # int32[L] end bit position (stream byte misalignment)
    nseq,  # int32[L]
    ll_p0,  # int32[L, 512]  baseline << 16 | nbits
    ll_p1,  # int32[L, 512]  value_base << 5 | value_extra_bits
    of_p0,
    of_p1,  # int32[L, 512]  offset code (value = (1 << code) + extra)
    ml_p0,
    ml_p1,
    ll_al,  # int32[L]
    of_al,
    ml_al,
    *,
    max_steps: int,
    wide: bool = False,
):
    """Decode L interleaved tANS sequence streams, 8 slots per step.

    Outputs are bit-packed because the decoded triples travel back to
    the host:

    * narrow (default, 8 B/slot): returns
      ``(pa uint32[steps, 8, L], pb uint32[steps, 8, L], ok bool[L])``
      with ``pa = valid << 31 | offset_value`` and
      ``pb = ll << 16 | ml``.  A lane whose stream needs more than the
      packed ranges (offset code >= 31, ll or ml > 0xFFFF — a >64 KiB
      literal run or match in ONE sequence) reports ``ok = False`` and
      the engine retries it on the wide form.
    * wide (12 B/slot): ``(pa, ll int32, ml int32, ok)`` — full RFC
      ranges (ll/ml <= 131074, offset_value < 2^31; bigger offsets are
      corrupt for any window <= 8 MiB and stay flagged).
    """
    return _sequences_scan(
        words, base, p0, pend, nseq, ll_p0, ll_p1, of_p0, of_p1, ml_p0, ml_p1,
        ll_al, of_al, ml_al, max_steps, wide,
    )


SEQ_LANE_COLS = 13  # lane_mat columns: base, p0, pend, nseq, w_ll,
#                     w_ml, w_of, ll_slot, of_slot, ml_slot, ll_al,
#                     of_al, ml_al


@partial(jax.jit, static_argnames=("max_steps", "n_dense_w"))
def decode_sequences_dense(
    words,
    lane_mat,  # int32[L, 13] stacked per-lane columns (SEQ_LANE_COLS)
    #            — ONE upload per call instead of 13
    cumw,  # int32[L + 1] prefix sums of per-lane packed word counts
    bank_flat0,  # int32[N] flat variable-size FSE table BANK planes,
    bank_flat1,  # uploaded once per plan (slot i = rows off[i]..off[i]+2^al)
    bank_off,  # int32[S] first row of each slot
    *,
    max_steps: int,
    n_dense_w: int,
):
    """Narrow-packed sequence decode with on-device word compaction.

    The never-stall invariant makes slot validity a per-lane prefix, so
    lane j's sequences are exactly its first nseq[j] slots — packed
    word-granularly here (see _pack_triples) into ONE
    uint32[n_dense_w + L] array: packed words (lane j's words at
    cumw[j]..cumw[j+1]) then per-lane ok flags.  The fetch moves 4 B
    (8 B for field-width sums > 32) per real sequence instead of the
    8 B da‖db planes."""
    (
        base, p0, pend, nseq, w_ll, w_ml, w_of,
        ll_slot, of_slot, ml_slot, ll_al, of_al, ml_al,
    ) = (lane_mat[:, c] for c in range(SEQ_LANE_COLS))
    row_iota = jax.lax.broadcasted_iota(jnp.int32, (1, 512), 1)

    def rows(flat, slot):
        # Variable-size slots: 512 rows from the slot's offset; rows
        # past a table's 2^al end are neighboring-table garbage that
        # the one-hot state select never touches (states < 2^al).
        idx = jnp.take(bank_off, slot)[:, None] + row_iota
        return jnp.take(flat, idx, mode="clip")

    pa, pb, ok = _sequences_scan(
        words, base, p0, pend, nseq,
        rows(bank_flat0, ll_slot),
        rows(bank_flat1, ll_slot),
        rows(bank_flat0, of_slot),
        rows(bank_flat1, of_slot),
        rows(bank_flat0, ml_slot),
        rows(bank_flat1, ml_slot),
        ll_al, of_al, ml_al, max_steps, False,
    )
    packed, over = _pack_triples(
        pa, pb, w_ll, w_ml, w_of, nseq, cumw, n_dense_w
    )
    # One output array per call — see decode_literals_dense.
    return jnp.concatenate([packed, (ok & ~over).astype(U32)])
