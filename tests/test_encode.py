"""Encoder tests: round-trips through our decoder AND libzstd, ratio
sanity vs libzstd, component golden checks (encode output <= libzstd's
size is the long-term target; round-trip exactness is the hard
gate)."""

import numpy as np
import pytest

from zstd_tpu import encode
from zstd_tpu.runtime.oracle import decompress as oracle
from zstd_tpu.testing import libzstd

pytestmark = pytest.mark.skipif(
    not libzstd.available(), reason="libzstd not available"
)


def _cases():
    rng = np.random.default_rng(42)
    return {
        "empty": b"",
        "one": b"x",
        "tiny": b"hello world",
        "rle": bytes(10_000),
        "rle_almost": bytes(5000) + b"x" + bytes(5000),
        "text": b"the quick brown fox jumps over the lazy dog. " * 500,
        "records": b"".join(
            b"id=%08d|name=user%04d;" % (i, i % 7919) for i in range(8000)
        ),
        "random": rng.bytes(50_000),
        "lowent": rng.choice(
            np.frombuffer(b"abcdefgh", np.uint8),
            120_000,
            p=[0.3, 0.2, 0.15, 0.1, 0.1, 0.05, 0.05, 0.05],
        ).tobytes(),
        "multiblock": (b"payload %d " * 60_000) % tuple(range(60_000)),
        "binary": bytes(range(256)) * 600,
    }


@pytest.mark.parametrize("name", list(_cases()))
def test_roundtrip_both_decoders(name):
    data = _cases()[name]
    for level in (0, 3, 12):
        comp = encode.compress(data, level, checksum=True)
        assert oracle(comp) == data, f"{name} lvl={level} oracle"
        assert libzstd.decompress(comp) == data, f"{name} lvl={level} libzstd"


def test_compression_actually_compresses():
    data = _cases()["multiblock"]
    comp = encode.compress(data, 3)
    assert len(comp) < len(data) // 4


@pytest.mark.parametrize(
    "name,bound",
    [
        ("text", 1.5),
        ("records", 1.5),
        ("lowent", 1.5),
        ("binary", 1.5),
        ("rle", 1.5),
        # The incrementing-counter synthetic (r2's 1.9x gap, closed in
        # r3 to 1.06x): the adaptive-priced optimal parse converges to
        # libzstd-1's parse SHAPE (1 literal + 1 rep sequence per
        # record); the residual ~5% is block-0 table ramp-up.  Note
        # even libzstd's own btopt (level 19) measures 1.9x libzstd-1
        # here — weak-parse luck, not parse strength, sets the floor.
        ("multiblock", 1.15),
    ],
)
def test_ratio_vs_libzstd_level1(name, bound):
    # North-star: encode output <= reference zstd size at same level.
    # The r2 hash-chain + lazy + rep-aware matcher beats libzstd-1
    # outright on realistic data (text/records/lowent <= 1.0x).
    data = _cases()[name]
    z1 = len(libzstd.compress(data, 1))
    ours = len(encode.compress(data, 3))
    assert ours <= bound * z1, f"{name}: ours {ours} vs libzstd-1 {z1}"


@pytest.mark.parametrize(
    "name,bound",
    [
        ("records", 1.0),   # optimal parse + repeat tables beat libzstd-1
        ("lowent", 1.0),
        ("text", 1.0),
        ("binary", 1.0),
        ("multiblock", 1.1),
    ],
)
def test_optimal_level_ratio_vs_libzstd_level1(name, bound):
    # Level 12 = adaptive-priced DP parse (zt_lz77_optimal) + cost-based
    # mode selection (Repeat/treeless) + whole-frame best-of.
    data = _cases()[name]
    z1 = len(libzstd.compress(data, 1))
    comp = encode.compress(data, 12)
    assert oracle(comp) == data
    assert libzstd.decompress(comp) == data
    assert len(comp) <= bound * z1, f"{name}: ours {len(comp)} vs libzstd-1 {z1}"


def test_levels_trade_effort_for_ratio():
    # Levels must actually change the search (r1's knob was cosmetic).
    rng = np.random.default_rng(11)
    words = [bytes(rng.integers(97, 123, int(n))) for n in rng.integers(2, 12, 256)]
    data = b" ".join(words[int(i)] for i in rng.integers(0, 256, 60_000))
    sizes = {lvl: len(encode.compress(data, lvl)) for lvl in (1, 3, 6)}
    assert sizes[3] <= sizes[1]
    assert sizes[6] < sizes[1]  # deeper search must find strictly more


def test_incompressible_stays_raw():
    data = np.random.default_rng(0).bytes(100_000)
    comp = encode.compress(data, 3)
    assert len(comp) < len(data) + 1024  # raw blocks + headers only


def test_store_mode():
    data = b"store me " * 1000
    comp = encode.compress(data, 0)
    assert oracle(comp) == data
    assert len(comp) >= len(data)  # no compression attempted


def test_checksum_written():
    data = b"checksummed " * 100
    comp = encode.compress(data, 3, checksum=True)
    bad = comp[:-1] + bytes([comp[-1] ^ 1])
    from zstd_tpu.utils.errors import ChecksumMismatch

    with pytest.raises(ChecksumMismatch):
        oracle(bad)


def test_offsets_to_values_inverse():
    # offsets -> values -> resolve round-trips through the decoder logic.
    from zstd_tpu.ops.sequence_codes import resolve_offset

    rng = np.random.default_rng(5)
    ll = rng.integers(0, 3, 200)
    offs = rng.integers(1, 50, 200)
    enc_rep = [1, 4, 8]
    vals = encode.offsets_to_values(ll, offs, enc_rep)
    dec_rep = [1, 4, 8]
    for i in range(200):
        got = resolve_offset(int(vals[i]), int(ll[i]), dec_rep)
        assert got == offs[i], i
    assert enc_rep == dec_rep


def test_pack_backward_stream_roundtrip():
    from zstd_tpu.utils.bits import BackwardBitCursor

    rng = np.random.default_rng(9)
    nbits = rng.integers(0, 25, 500)
    values = np.array([int(rng.integers(0, 1 << n)) if n else 0 for n in nbits])
    data = encode.pack_backward_stream(values, nbits)
    cur = BackwardBitCursor(data)
    # Reader consumes in reverse write order.
    for v, n in list(zip(values, nbits))[::-1]:
        assert cur.take(int(n)) == int(v)
    assert cur.is_empty


def test_huffman_codes_complete():
    rng = np.random.default_rng(3)
    freqs = np.zeros(256, dtype=np.int64)
    syms = rng.choice(256, 40, replace=False)
    freqs[syms] = rng.integers(1, 10_000, 40)
    codes, lengths, max_bits = encode.huffman_codes(freqs)
    assert max_bits <= 11
    # Kraft equality.
    assert sum(1 << (max_bits - l) for l in lengths[lengths > 0]) == 1 << max_bits


def test_weights_serialization_roundtrip():
    # Direct and FSE-compressed weight forms parse back identically
    # (the FSE form exercises the two-state alternating decoder).
    from zstd_tpu.ops.huffman import parse_huffman_weights
    from zstd_tpu.utils.bits import ForwardByteCursor

    rng = np.random.default_rng(11)
    fse_seen = direct_seen = 0
    for _ in range(120):
        nsym = int(rng.integers(2, 200))
        freqs = np.zeros(256, np.int64)
        syms = rng.choice(256, nsym, replace=False)
        freqs[syms] = rng.integers(1, 100_000, nsym)
        codes, lengths, mb = encode.huffman_codes(freqs)
        ser = encode.serialize_huffman_weights(lengths, mb)
        if ser is None:
            continue
        if ser[0] < 128:
            fse_seen += 1
        else:
            direct_seen += 1
        got = parse_huffman_weights(ForwardByteCursor(ser))
        weights = np.where(lengths > 0, mb + 1 - lengths, 0)
        last = int(np.flatnonzero(weights)[-1])
        assert list(got) == list(weights[:last])
    assert fse_seen  # compressed form exercised
    # Direct form: adjacent symbols with uniform weights -> the explicit
    # weight list has a single distinct value, FSE degenerates, direct
    # form chosen.
    freqs = np.zeros(256, np.int64)
    freqs[[0, 1, 2, 3]] = 10
    codes, lengths, mb = encode.huffman_codes(freqs)
    ser = encode.serialize_huffman_weights(lengths, mb)
    assert ser is not None and ser[0] >= 128
    got = parse_huffman_weights(ForwardByteCursor(ser))
    weights = np.where(lengths > 0, mb + 1 - lengths, 0)
    last = int(np.flatnonzero(weights)[-1])
    assert list(got) == list(weights[:last])


def test_large_alphabet_compresses():
    # >128 distinct symbols requires the FSE-compressed weights form.
    data = bytes(range(256)) * 600
    comp = encode.compress(data, 3)
    assert len(comp) < len(data) // 10
    assert libzstd.decompress(comp) == data


def test_fse_distribution_roundtrip():
    from zstd_tpu.ops.fse import parse_fse_distribution
    from zstd_tpu.utils.bits import ForwardBitCursor

    freqs = np.array([100, 50, 3, 1, 0, 7, 900], dtype=np.int64)
    al = 7
    dist = encode.normalize_distribution(freqs, al)
    assert int(np.where(dist == -1, 1, dist).sum()) == 1 << al
    fb = encode.ForwardBits()
    encode.serialize_fse_distribution(al, dist, fb)
    got_al, got = parse_fse_distribution(ForwardBitCursor(fb.to_bytes()))
    assert got_al == al
    padded = list(dist)
    while padded and padded[-1] == 0:
        padded.pop()
    assert got == padded


def test_multi_frame_concat_with_reference_corpus(corpus):
    # Our encoder's frames concatenate with libzstd frames.
    mine = encode.compress(b"ours " * 500, 3, checksum=True)
    data = corpus["romeo.txt.zst"] + mine
    out = oracle(data)
    assert out.endswith(b"ours " * 500)


def test_engine_decodes_repeat_and_treeless_output():
    # The r3 encoder emits FSE Repeat mode and treeless literals across
    # blocks; the batched device engine must decode them bit-exactly
    # (repeat chains become shared table-bank slots, treeless lanes
    # reuse the cached Huffman table — format/block_table.py).
    from zstd_tpu.runtime.engine import DeviceEngine

    rng = np.random.default_rng(21)
    words = [bytes(rng.integers(97, 123, int(n))) for n in rng.integers(2, 12, 256)]
    data = b" ".join(words[int(i)] for i in rng.integers(0, 256, 120_000))
    comp = encode.compress(data, 12, checksum=True)
    # Sanity: multi-block output actually exercises cross-block reuse.
    from zstd_tpu.format.block_table import build_batch_plan

    plan = build_batch_plan(comp)
    assert sum(len(f.blocks) for f in plan.frames) >= 3
    eng = DeviceEngine()
    assert eng.decompress(comp) == data
    assert eng.stats.fallback_frames == 0
