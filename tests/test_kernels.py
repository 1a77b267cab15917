"""Device-kernel building-block tests.

The buffered bit window (kernels/bitbuf.py) is validated against the
host BackwardBitCursor on random streams; the device LZ77
source-map builder against the host executor.  These run on whatever
JAX platform is available (tiny shapes)."""

import numpy as np
import pytest

from zstd_tpu.utils.bits import BackwardBitCursor, backward_start_bitpos


def _to_words(payload: bytes):
    pad = (-len(payload)) % 4
    buf = payload + b"\x00" * (pad + 4)
    return np.frombuffer(buf, dtype="<u4").copy()


@pytest.mark.parametrize("nwords", [3, 4])
def test_bitbuf_matches_host_cursor(nwords):
    import jax.numpy as jnp

    from zstd_tpu.kernels import bitbuf

    rng = np.random.default_rng(nwords)
    # Build several random backward streams and a per-lane read schedule.
    payloads = [rng.bytes(int(n)) + b"\x01" for n in rng.integers(4, 60, 8)]
    words = jnp.asarray(np.concatenate([_to_words(p) for p in payloads]))
    bases, p0s = [], []
    off = 0
    for p in payloads:
        bases.append(off)
        p0s.append(backward_start_bitpos(p))
        off += len(_to_words(p))
    base = jnp.asarray(np.array(bases, np.int32))
    p0 = jnp.asarray(np.array(p0s, np.int32))

    bs, nbits, wi, top = bitbuf.buf_init(p0, nwords)
    bs, nbits, wi = bitbuf.buf_insert_top(bs, nbits, wi, top, words, base)
    for _ in range(nwords - 1):
        bs, nbits, wi = bitbuf.buf_refill(bs, nbits, wi, words, base)

    cursors = [BackwardBitCursor(p) for p in payloads]
    reads = rng.integers(0, 14, size=(30, len(payloads)))
    for row in reads:
        # Refill then take, like the kernels do.
        bs, nbits, wi = bitbuf.buf_refill(bs, nbits, wi, words, base)
        n = jnp.asarray(row.astype(np.int32))
        v, bs, nbits = bitbuf.buf_take(bs, nbits, n)
        got = np.asarray(v)
        for i, cur in enumerate(cursors):
            want = cur.peek_padded(int(row[i]))
            # peek_padded pads right; buf_take pads with phantom zeros
            # identically once the stream is exhausted.
            cur.pos = max(0, cur.pos - int(row[i]))
            assert got[i] == want, (i, row[i])


def test_source_map_matches_host_executor():
    from zstd_tpu.kernels.lz77_device import build_source_map
    from zstd_tpu.ops.lz77 import execute_sequences
    from zstd_tpu.ops.sequence_codes import INITIAL_REPEAT_OFFSETS

    rng = np.random.default_rng(4)
    for trial in range(20):
        nseq = int(rng.integers(1, 20))
        seqs = []
        out_len = int(rng.integers(1, 30))  # pre-existing frame output
        prior = rng.integers(0, 256, out_len, dtype=np.uint8)
        lits = rng.integers(0, 256, 400, dtype=np.uint8)
        consumed = 0
        cur_len = out_len
        for _ in range(nseq):
            ll = int(rng.integers(0, 20))
            ml = int(rng.integers(3, 20))
            max_off = cur_len + ll
            off = int(rng.integers(1, max_off + 1))
            seqs.append((ll, off + 3, ml))  # explicit offset_value
            consumed += ll
            cur_len += ll + ml
        lits = lits[: consumed + int(rng.integers(0, 10))]

        # Host executor.
        out = bytearray(prior.tobytes())
        rep1 = list(INITIAL_REPEAT_OFFSETS)
        execute_sequences(out, seqs, lits.tobytes(), rep1)

        # Device source map + NumPy chase (same semantics as the kernel).
        rep2 = list(INITIAL_REPEAT_OFFSETS)
        lla = np.array([s[0] for s in seqs], dtype=np.int64)
        ofva = np.array([s[1] for s in seqs], dtype=np.uint32)
        mla = np.array([s[2] for s in seqs], dtype=np.int64)
        src, total = build_source_map(lla, ofva, mla, len(lits), rep2, out_len)
        assert rep1 == rep2
        res = np.empty(total, dtype=np.uint8)
        full = np.concatenate([prior, res])
        for j in range(total):
            s = src[j]
            full[out_len + j] = lits[-s - 1] if s < 0 else full[s]
        assert full.tobytes() == bytes(out), trial


def test_huffman_flat_matches_table():
    # The Triton kernels' flat 2^11 Huffman tables must give every
    # 11-bit window the symbol and code length of the host flat table.
    from zstd_tpu.format.block_table import pack_huffman_canonical
    from zstd_tpu.kernels.triton_decode import huffman_flat
    from zstd_tpu.ops.huffman import parse_huffman_table
    from zstd_tpu.testing import libzstd
    from zstd_tpu.utils.bits import ForwardByteCursor

    if not libzstd.available():
        pytest.skip("libzstd not available")
    from zstd_tpu.format.frame import iter_frames

    rng = np.random.default_rng(11)
    tables = []
    for k in range(4):
        alphabet = np.frombuffer(bytes(range(97, 97 + 6 + 20 * k)), np.uint8)
        p = rng.random(len(alphabet)) ** 3
        payload = rng.choice(alphabet, 40_000, p=p / p.sum()).tobytes()
        frame = next(iter_frames(libzstd.compress(payload, 3)))
        for block in frame.blocks:
            lit = getattr(block, "literals", None)
            if lit is not None and lit.huffman_payload is not None:
                tables.append(parse_huffman_table(ForwardByteCursor(lit.huffman_payload)))
    assert tables
    canon = [pack_huffman_canonical(t) for t in tables]
    flat = huffman_flat(*(np.stack([c[k] for c in canon]) for k in
                          ("limits", "prevs", "lengths", "rankb", "ranked")))
    for t, row in zip(tables, flat):
        scale = 11 - t.max_bits
        idx = np.arange(2048) >> scale
        assert np.array_equal(row & 0xFF, t.symbol[idx])
        assert np.array_equal(row >> 8, t.nbits[idx])
