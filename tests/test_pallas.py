"""Differential coverage for the Pallas-Triton decode kernels.

``decode_literals_gpu`` and ``decode_sequences_gpu``
(kernels/triton_decode.py) are the engine's GPU path.  On the CPU these
tests drive the exact kernel bodies in Pallas interpret mode (on a GPU,
compiled) against the lax.scan forms on real streams: level-3 text,
level-19 repeat/treeless streams, a stall-heavy handcrafted frame
(near-worst-case bit bursts), and a packed-field-overflow lane
(ll > 0xFFFF -> wide-retry flag parity).  The ``gpu``-marked test runs
the sequences kernel at a ~1 M-sequence call on the card.
"""

import numpy as np
import pytest

from zstd_tpu.format.block_table import build_batch_plan
from zstd_tpu.runtime.engine import DeviceEngine, _handles
from zstd_tpu.runtime.oracle import decompress as oracle_decompress
from zstd_tpu.testing import libzstd


def _engine(route: str) -> DeviceEngine:
    """An engine pinned to a kernel family; "kernel" compiles the
    Triton kernels on a GPU and interprets them elsewhere."""
    import jax

    eng = DeviceEngine()
    if route == "kernel" and jax.default_backend() != "gpu":
        route = "interpret"
    eng._route_pin = route
    return eng


def _assert_lane_parity(data: bytes):
    """Both kernel families must produce identical per-lane outputs."""
    plan = build_batch_plan(data)
    (lo_k, lk_k), (so_k, sk_k) = _engine("kernel")._run_both(plan)
    (lo_s, lk_s), (so_s, sk_s) = _engine("scan")._run_both(plan)
    assert np.array_equal(lk_k, lk_s)
    assert np.array_equal(sk_k, sk_s)
    for lane, (a, b) in enumerate(zip(lo_k, lo_s)):
        if a is None or b is None:
            assert a is b, lane
            continue
        assert np.array_equal(a, b), f"literal lane {lane}"
    for lane, (ta, tb) in enumerate(zip(so_k, so_s)):
        if ta is None or tb is None:
            assert ta is tb, lane
            continue
        for k in range(3):
            assert np.array_equal(ta[k], tb[k]), f"seq lane {lane} field {k}"
    return plan


def _assert_engine_exact(data: bytes, payload: bytes):
    """Kernels forced on: no silent fallback, bit-exact output."""
    eng = _engine("kernel")
    assert eng.decompress(data) == payload
    assert eng.stats.fallback_frames == 0, eng.stats.fallback_reasons
    assert eng.stats.kernel_calls > 0


def _level3_text():
    payload = (b"the quick brown fox %04d jumps over the lazy dog " * 250) % (
        tuple(range(250))
    )
    data = b"".join(
        libzstd.compress(payload[i::3], 3, checksum=True) for i in range(3)
    )
    return data, b"".join(payload[i::3] for i in range(3))


def _level19_repeat_streams():
    rng = np.random.default_rng(7)
    page = rng.bytes(2048)
    payload = b"".join(
        bytes(bytearray(page)[: 2000 + int(rng.integers(0, 48))])
        for _ in range(12)
    )
    return libzstd.compress(payload, 19, checksum=True), payload


def _stall_heavy_frame_small():
    """Sequence streams with near-worst-case bit bursts (large offsets
    into 1 MiB of raw history + spread FSE codes), sized down from
    test_engine._stall_heavy_frame for interpret-mode speed."""
    from zstd_tpu.encode import (
        MAGIC_ZSTD,
        _frame_header,
        encode_literals_section,
        encode_sequences_section,
        offsets_to_values,
    )

    rng = np.random.default_rng(0xFEED)
    out = bytearray(MAGIC_ZSTD.to_bytes(4, "little"))
    history = 1 << 20
    payload = bytearray(rng.bytes(history))
    body_blocks = []
    for start in range(0, history, 128 << 10):
        chunk = payload[start : start + (128 << 10)]
        header = 0 | (0 << 1) | (len(chunk) << 3)
        body_blocks.append(header.to_bytes(3, "little") + bytes(chunk))

    rep = [1, 4, 8]
    for _b in range(2):
        lls, offs, mls = [], [], []
        budget = 14 << 10
        out_so_far = len(payload)
        while budget > 2900:
            ll = int(rng.integers(300, 2000))
            ml = int(rng.integers(3, 800))
            off = int(rng.integers(1 << 16, min(out_so_far, 1 << 20)))
            lls.append(ll)
            offs.append(off)
            mls.append(ml)
            budget -= ll + ml
            out_so_far += ll + ml
        lls, offs, mls = map(np.asarray, (lls, offs, mls))
        lits = rng.integers(0, 256, int(lls.sum()), dtype=np.uint8)
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
    body_blocks.append((1 | (0 << 1) | (0 << 3)).to_bytes(3, "little"))
    out += _frame_header(len(payload), False, False, 21)
    out += b"".join(body_blocks)
    return bytes(out), bytes(payload)


def _overflow_lane_frame():
    """One sequence with ll > 0xFFFF: overflows the narrow 16-bit
    packed field, so the lane must be flagged for the wide retry."""
    from zstd_tpu.encode import (
        MAGIC_ZSTD,
        _frame_header,
        encode_literals_section,
        encode_sequences_section,
        offsets_to_values,
    )

    rng = np.random.default_rng(3)
    lits = rng.integers(0, 256, 72_000, dtype=np.uint8)
    lls = np.asarray([70_000, 1_500], dtype=np.int64)
    offs = np.asarray([1_000, 40_000])
    mls = np.asarray([500, 700], dtype=np.int64)
    payload = bytearray(bytes(lits[:70_000]))
    for _ in range(500):
        payload.append(payload[-1_000])
    payload += bytes(lits[70_000:71_500])
    for _ in range(700):
        payload.append(payload[-40_000])
    payload += bytes(lits[71_500:])
    ofv = offsets_to_values(lls, offs, [1, 4, 8])
    body = encode_literals_section(lits) + encode_sequences_section(lls, ofv, mls)
    data = bytes(
        MAGIC_ZSTD.to_bytes(4, "little")
        + _frame_header(len(payload), False, False, 20)
        + (1 | (2 << 1) | (len(body) << 3)).to_bytes(3, "little")
        + bytes(body)
    )
    return data, bytes(payload)


def _pre_retry_flags(data: bytes):
    """Per-engine sequence ok flags before the wide retry."""
    plan = build_batch_plan(data)
    assert plan.n_seq_lanes > 0
    flags = []
    for route in ("kernel", "scan"):
        eng = _engine(route)
        outs, ok, pending = eng._dispatch_sequences(plan)
        it = eng._fetch_stream(_handles(pending))
        eng._finish_sequences(plan, pending, outs, ok, it)
        flags.append(ok.copy())
    return flags


SCENARIOS = {
    "level3_text": _level3_text,
    "level19_repeat_streams": _level19_repeat_streams,
    "stall_heavy": _stall_heavy_frame_small,
    "overflow_lane_flag_parity": _overflow_lane_frame,
}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_kernel_matches_scan(scenario):
    data, payload = SCENARIOS[scenario]()
    assert oracle_decompress(data) == payload  # construction sanity
    if scenario == "overflow_lane_flag_parity":
        kernel_ok, scan_ok = _pre_retry_flags(data)
        assert np.array_equal(kernel_ok, scan_ok)
        assert not kernel_ok.all()  # the overflow lane is flagged
    plan = _assert_lane_parity(data)
    if scenario == "level3_text":
        assert plan.n_lit_lanes > 0 and plan.n_seq_lanes > 0
    _assert_engine_exact(data, payload)


@pytest.mark.gpu
def test_sequences_kernel_big_call(gpu):
    # Low-entropy ACGT noise yields ~1 M sequences in one call of the
    # compiled sequences kernel; it must decode them all, bit-exact.
    rng = np.random.default_rng(5)
    payload = rng.choice(
        np.frombuffer(b"ACGT", dtype=np.uint8), 8 << 20
    ).tobytes()
    data = libzstd.compress(payload, 3, checksum=True)
    plan = build_batch_plan(data)
    assert int(plan.seq_nseq.sum()) >= (1 << 19)

    eng = DeviceEngine()
    assert eng._route() == "kernel"
    out = eng.decompress(data)
    assert out == payload
    assert eng.stats.fallback_frames == 0, eng.stats.fallback_reasons
    assert eng.stats.kernel_calls > 0
