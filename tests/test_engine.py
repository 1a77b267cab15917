"""Device-engine tests (CPU backend, virtual devices via conftest).

The engine must be bit-exact with the host oracle and libzstd through
the batched kernel path — and must fall back to the oracle, not fail,
when a lane's status check trips."""

import numpy as np
import pytest

from zstd_tpu.format.block_table import build_batch_plan
from zstd_tpu.runtime.engine import DeviceEngine, _kernel_lanes, _tier_split
from zstd_tpu.runtime.oracle import decompress as oracle_decompress
from zstd_tpu.testing import libzstd

pytestmark = pytest.mark.skipif(
    not libzstd.available(), reason="libzstd not available"
)


@pytest.fixture(scope="module")
def engine():
    return DeviceEngine()


def _check(engine, payload: bytes, level: int = 3, **kw):
    comp = libzstd.compress(payload, level, **kw)
    out = engine.decompress(comp)
    assert out == payload
    return engine.stats


def test_corpus_through_engine(engine, corpus):
    for name, data in corpus.items():
        assert engine.decompress(data) == libzstd.decompress(data), name


def test_compressed_block_no_fallback(engine):
    # Compressible payload -> huffman literals + fse sequences on device.
    payload = (b"engine test payload %d " * 500) % tuple(range(500))
    stats = _check(engine, payload, 6, checksum=True)
    assert stats.lit_lanes > 0 and stats.seq_lanes > 0
    assert stats.fallback_frames == 0


def test_rle_and_raw_blocks(engine):
    _check(engine, bytes(2000), 1)  # RLE-ish
    _check(engine, np.random.default_rng(0).bytes(2000), 3)  # raw block


def test_treeless_and_repeat_paths(engine):
    # Multi-block input reuses Huffman tables / FSE modes across blocks.
    rng = np.random.default_rng(1)
    words = [bytes(rng.integers(97, 103, 8)) for _ in range(64)]
    payload = b" ".join(words[int(i)] for i in rng.integers(0, 64, 80_000))
    stats = _check(engine, payload, 3)
    assert stats.blocks >= 2
    assert stats.fallback_frames == 0


def test_4stream_literals(engine):
    # Literal-heavy payload (few matches, skewed byte histogram) so the
    # encoder emits a large huffman-compressed literals section -> 4
    # streams (literals.rs:108-123 jump table path).
    rng = np.random.default_rng(3)
    payload = rng.choice(
        np.frombuffer(b"abcdefgh", dtype=np.uint8), 60_000, p=[0.3, 0.2, 0.15, 0.1, 0.1, 0.05, 0.05, 0.05]
    ).tobytes()
    comp = libzstd.compress(payload, 3)
    plan = build_batch_plan(comp)
    # 4-stream blocks produce 4 lanes per compressed-literals block.
    frames = [f for f in plan.frames if f.blocks]
    lit_counts = [len(b.lit_streams) for f in frames for b in f.blocks]
    assert any(c == 4 for c in lit_counts)
    assert engine.decompress(comp) == payload


def test_corrupt_stream_falls_back_to_oracle_error(engine):
    # A corrupted entropy stream must surface a *typed* error (via oracle
    # fallback), not bad bytes and not an untyped crash.
    from zstd_tpu.utils.errors import ZstdError

    payload = (b"corrupt me " * 2000)
    base = libzstd.compress(payload, 6, checksum=True)
    errors = 0
    for pos in range(20, len(base), max(1, len(base) // 16)):
        comp = bytearray(base)
        comp[pos] ^= 0x55
        try:
            out = engine.decompress(bytes(comp))
        except ZstdError:
            errors += 1
            continue
        # If it decodes, the checksum passed — output must be payload.
        assert out == payload
    assert errors > 0  # at least one mutation must be detected


def test_sequence_dispatch_honesty(monkeypatch):
    # The wide kernel dispatch must actually run (no silent oracle
    # fallback) and its bytes must match libzstd.
    payload = (b"dispatch honesty %d " * 600) % tuple(range(600))
    comp = libzstd.compress(payload, 6, checksum=True)
    calls = []
    orig_w = DeviceEngine._dispatch_sequences
    monkeypatch.setattr(
        DeviceEngine,
        "_dispatch_sequences",
        lambda self, plan, subset=None: calls.append("wide")
        or orig_w(self, plan, subset),
    )
    eng_w = DeviceEngine()
    out_w = eng_w.decompress(comp)
    assert calls == ["wide"]
    assert eng_w.stats.fallback_frames == 0
    assert out_w == payload


def test_engine_matches_oracle_on_mixed_frames(engine):
    a = libzstd.compress(b"frame one " * 300, 5, checksum=True)
    skip = b"\x53\x2a\x4d\x18" + (4).to_bytes(4, "little") + b"SKIP"
    b = libzstd.compress(np.random.default_rng(2).bytes(5000), 1)
    data = a + skip + b
    assert engine.decompress(data) == oracle_decompress(data)
    assert engine.decompress(data, include_skippable=True) == oracle_decompress(
        data, include_skippable=True
    )


def test_tier_split():
    counts = np.array([0, 10, 100, 100, 5000, 64, 65])
    tiers = _tier_split(counts, lo=4)
    seen = [lane for idx, _ in tiers for lane in idx]
    assert sorted(seen) == [1, 2, 3, 4, 5, 6]  # lane 0 dropped (0 steps)
    for idx, steps in tiers:
        assert (counts[idx] <= steps).all()
    # The 5000-step outlier must not drag the small lanes' call size up.
    assert len(tiers) == 2
    small_steps = dict((int(i), s) for idx, s in tiers for i in idx)
    assert small_steps[1] < 5000
    # Uniform needs -> one call.
    assert len(_tier_split(np.full(16, 100), lo=4)) == 1


def test_kernel_lanes_sort_and_padding():
    # GPU dispatch layout: lanes with work sorted by descending need,
    # padded with -1 rows to a pow2 count of whole 16-lane blocks, and
    # each block's loop bound its own largest need.
    need = np.array([5, 0, 90, 7, 90, 1, 33] + [2] * 14)
    rows, blk = _kernel_lanes(need, 16)
    assert len(rows) == 32 and (rows >= 0).sum() == 20
    real = rows[:20]
    assert list(real[:4]) == [2, 4, 6, 3]  # stable among equal needs
    assert (np.diff(need[real]) <= 0).all() and 1 not in real
    assert (rows[20:] == -1).all()
    assert list(blk) == [90, 2]
    # No live lane -> nothing to dispatch.
    rows, blk = _kernel_lanes(np.zeros(5, np.int64), 16)
    assert len(rows) == 0 and len(blk) == 0


def test_mesh_rows_spread_over_devices():
    # On a mesh every device's block of rows gets an equal share of the
    # real lanes (a tail of padding would leave the last devices idle).
    class _Mesh:
        class devices:
            size = 4

    eng = DeviceEngine(mesh=_Mesh())
    rows = eng._pad_lanes(np.arange(10, 20))
    assert len(rows) == 32
    per_device = (rows.reshape(4, 8) >= 0).sum(axis=1)
    assert list(per_device) == [3, 3, 2, 2]
    assert sorted(rows[rows >= 0].tolist()) == list(range(10, 20))
    single = DeviceEngine()._pad_lanes(np.arange(10, 20))
    assert list(single[:10]) == list(range(10, 20)) and (single[10:] == -1).all()


def test_route_choice():
    # The Triton kernels run only on a GPU without a mesh; a test pin
    # overrides.
    import jax

    eng = DeviceEngine()
    want = "kernel" if jax.default_backend() == "gpu" else "scan"
    assert eng._route() == want
    eng.mesh = object()
    assert eng._route() == "scan"
    eng._route_pin = "interpret"
    assert eng._route() == "interpret"


def test_device_execute_path(corpus):
    # Pure-device LZ77 execution (pointer-doubling kernel) must match.
    eng = DeviceEngine(device_execute=True)
    data = corpus["romeo.txt.zst"]
    assert eng.decompress(data) == libzstd.decompress(data)
    payload = (b"device exec %d " * 800) % tuple(range(800))
    comp = libzstd.compress(payload, 6, checksum=True)
    assert eng.decompress(comp) == payload


def test_stats_populated(engine):
    payload = b"stats payload " * 1000
    stats = _check(engine, payload, 6)
    d = stats.as_dict()
    assert d["bytes_out"] == len(payload)
    assert d["bytes_in"] > 0
    assert set(d["wall_s"]) == {"prepass", "kernels", "assembly", "total"}


def _stall_heavy_frame():
    """Handcraft a frame whose sequence streams sustain near-worst-case
    bit bursts (large-offset + large-ll/ml extras + spread FSE codes) —
    the workload that pins the kernels' never-stall invariant
    (entropy2.SEQ_BUF_WORDS) and the exact step bounds."""
    from zstd_tpu.encode import (
        MAGIC_ZSTD,
        _frame_header,
        encode_literals_section,
        encode_sequences_section,
        offsets_to_values,
    )

    rng = np.random.default_rng(0xBEEF)
    out = bytearray(MAGIC_ZSTD.to_bytes(4, "little"))
    history = 1 << 22  # 4 MiB of raw-block history for big offsets
    payload = bytearray(rng.bytes(history))
    nblocks_hdr = []

    body_blocks = []
    # Raw history blocks.
    for start in range(0, history, 128 << 10):
        chunk = payload[start : start + (128 << 10)]
        header = 0 | (0 << 1) | (len(chunk) << 3)
        body_blocks.append(header.to_bytes(3, "little") + bytes(chunk))

    rep = [1, 4, 8]
    for _b in range(4):
        lls, offs, mls = [], [], []
        budget = 120 << 10
        out_so_far = len(payload)
        while budget > 1200:
            ll = int(rng.integers(300, 2000))
            ml = int(rng.integers(3, 800))
            off = int(rng.integers(1 << 16, min(out_so_far, 1 << 22)))
            lls.append(ll)
            offs.append(off)
            mls.append(ml)
            budget -= ll + ml
            out_so_far += ll + ml
        lls, offs, mls = map(np.asarray, (lls, offs, mls))
        lits = rng.integers(0, 256, int(lls.sum()), dtype=np.uint8)
        # Materialize the decoded bytes (ground truth by construction).
        lp = 0
        for ll, off, ml in zip(lls, offs, mls):
            payload += bytes(lits[lp : lp + ll])
            lp += ll
            for _ in range(ml):
                payload.append(payload[-off])
        ofv = offsets_to_values(lls.astype(np.int64), offs, rep)
        body = encode_literals_section(lits) + encode_sequences_section(
            lls.astype(np.int64), ofv, mls.astype(np.int64)
        )
        header = 0 | (2 << 1) | (len(body) << 3)
        body_blocks.append(header.to_bytes(3, "little") + body)
    # Close with an empty raw last block.
    body_blocks.append((1 | (0 << 1) | (0 << 3)).to_bytes(3, "little"))

    out += _frame_header(len(payload), False, False, 23)
    out += b"".join(body_blocks)
    del nblocks_hdr
    return bytes(out), bytes(payload)


def test_packed_overflow_retries_on_wide_kernel():
    # One sequence with a >64 KiB literal run overflows the narrow
    # 8 B/slot packing (ll > 0xFFFF) — the engine must transparently
    # retry that lane on the wide kernel, with no oracle fallback.
    from zstd_tpu.encode import (
        MAGIC_ZSTD,
        _frame_header,
        encode_literals_section,
        encode_sequences_section,
        offsets_to_values,
    )

    rng = np.random.default_rng(7)
    lits = rng.integers(0, 256, 80_000, dtype=np.uint8)
    lls = np.asarray([70_000, 9_000], dtype=np.int64)
    offs = np.asarray([1_000, 40_000])
    mls = np.asarray([500, 700], dtype=np.int64)
    payload = bytearray(bytes(lits[:70_000]))
    for _ in range(500):
        payload.append(payload[-1_000])
    payload += bytes(lits[70_000:79_000])
    for _ in range(700):
        payload.append(payload[-40_000])
    payload += bytes(lits[79_000:])
    ofv = offsets_to_values(lls, offs, [1, 4, 8])
    body = encode_literals_section(lits) + encode_sequences_section(lls, ofv, mls)
    data = bytes(
        MAGIC_ZSTD.to_bytes(4, "little")
        + _frame_header(len(payload), False, False, 20)
        + (1 | (2 << 1) | (len(body) << 3)).to_bytes(3, "little")
        + bytes(body)
    )
    assert oracle_decompress(data) == bytes(payload)
    if libzstd.available():
        assert libzstd.decompress(data) == bytes(payload)
    eng = DeviceEngine()
    assert eng.decompress(data) == bytes(payload)
    assert eng.stats.fallback_frames == 0


def test_stall_heavy_sequences_no_fallback():
    data, payload = _stall_heavy_frame()
    # Sanity: the host oracle agrees with the construction.
    assert oracle_decompress(data) == payload
    if libzstd.available():
        assert libzstd.decompress(data) == payload
    eng = DeviceEngine()
    assert eng.decompress(data) == payload
    assert eng.stats.fallback_frames == 0


def test_injected_kernel_exception_falls_back_to_oracle(monkeypatch):
    # The engine's one absolute promise (engine.py module docstring):
    # bit-exact by construction.  An UNanticipated exception class from
    # the kernel phase — not just an ok-flag trip — must degrade to the
    # oracle, never escape to the caller.
    payload = (b"exception safety %d " * 400) % tuple(range(400))
    comp = libzstd.compress(payload, 6, checksum=True)

    def boom(self, plan, subset=None):
        raise ValueError("injected kernel bug")

    # _dispatch_sequences underlies both the frame-pipelined path and
    # the classic _run_both path, so the injected failure exercises the
    # pipelined replan AND the final oracle degrade.
    monkeypatch.setattr(DeviceEngine, "_dispatch_sequences", boom)
    eng = DeviceEngine()
    out = eng.decompress(comp)
    assert out == payload
    assert eng.stats.fallback_frames >= 1
    assert any("kernel phase" in r for r in eng.stats.fallback_reasons)


def test_injected_assembly_exception_falls_back_to_oracle(monkeypatch):
    payload = (b"assembly safety %d " * 400) % tuple(range(400))
    comp = libzstd.compress(payload, 6, checksum=True)

    def boom(self, fp, lit_outs, seq_outs):
        raise IndexError("injected assembly bug")

    monkeypatch.setattr(DeviceEngine, "_assemble_frame", boom)
    eng = DeviceEngine()
    out = eng.decompress(comp)
    assert out == payload
    assert eng.stats.fallback_frames >= 1
    assert any("assembly" in r for r in eng.stats.fallback_reasons)


def test_fetch_thread_exception_falls_back_to_oracle(monkeypatch):
    # The streaming fetch (engine._fetch_stream) raises worker-thread
    # exceptions at the consuming next(); that must route through the
    # same last-resort oracle fallback as a dispatch-side failure.
    payload = (b"fetch thread safety %d " * 400) % tuple(range(400))
    comp = libzstd.compress(payload, 6, checksum=True)

    def boom(self, xs):
        handles = list(xs)

        def gen():
            raise OSError("injected fetch failure")
            yield  # pragma: no cover

        return gen() if handles else iter(())

    monkeypatch.setattr(DeviceEngine, "_fetch_stream", boom)
    eng = DeviceEngine()
    out = eng.decompress(comp)
    assert out == payload
    assert eng.stats.fallback_frames >= 1


def test_frame_pipelined_groups_bit_exact(monkeypatch):
    # >1 MiB of compressed multi-frame input must split into several
    # pipelined plan groups (prepass overlapping dispatch) and still
    # produce bit-exact output with zero fallbacks; skippable frames
    # may land at group boundaries.
    rng = np.random.default_rng(21)
    parts, skip = [], b"\x53\x2a\x4d\x18" + (4).to_bytes(4, "little") + b"SKIP"
    expect = bytearray()
    for i in range(12):
        blob = rng.integers(97, 123, 200_000, dtype=np.uint8).tobytes()
        parts.append(libzstd.compress(blob, 1, checksum=True))
        expect += blob
        if i % 3 == 0:
            parts.append(skip)
    data = b"".join(parts)
    assert len(data) > (1 << 20) + (256 << 10)  # >= 2 pipeline groups

    groups_seen = []
    orig = DeviceEngine._iter_pipelined

    def spy(self, d, w):
        n = 0
        for g in orig(self, d, w):
            n += 1
            yield g
        groups_seen.append(n)

    monkeypatch.setattr(DeviceEngine, "_iter_pipelined", spy)
    eng = DeviceEngine()
    out = eng.decompress(data)
    assert out == bytes(expect)
    assert eng.stats.fallback_frames == 0
    assert groups_seen and groups_seen[0] >= 2, groups_seen
