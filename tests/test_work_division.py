"""Dispatch-level work-division evidence for multi-process scaling.

Scaling across processes cannot be timed here, so this test pins the
thing the design actually controls: with lane counts well above the
pow2 padding floor, the per-process KERNEL WORK the engine dispatches
on the GPU path — lane-block loop steps summed over the call's blocks
and fetched output words — must shrink ~1/P under
``shard_lanes_balanced`` bins for P in {2, 4, 8}.  The kernels are
stubbed, so this asserts the dispatch schedule itself, not speed.
"""

import numpy as np
import pytest

from zstd_tpu.format.block_table import build_batch_plan
from zstd_tpu.parallel.dist import shard_lanes_balanced
from zstd_tpu.runtime.engine import DeviceEngine
from zstd_tpu.testing import libzstd

pytestmark = pytest.mark.skipif(
    not libzstd.available(), reason="libzstd not available"
)


@pytest.fixture(scope="module")
def big_plan():
    # Many small frames -> lots of independent lanes (well above the
    # 32-lane pad floor even at P = 8).
    rng = np.random.default_rng(11)
    frames = []
    for _ in range(420):
        # Low-entropy noise (Huffman literal streams) + page repeats
        # with edits (sequence streams) in every frame.
        lit_part = rng.integers(97, 123, int(rng.integers(6_000, 14_000)), dtype=np.uint8).tobytes()
        page = rng.integers(0, 256, 512, dtype=np.uint8)
        seq_part = b"".join(
            (page + np.uint8(k)).tobytes() for k in rng.integers(0, 3, 24)
        )
        frames.append(libzstd.compress(lit_part + seq_part, 3, checksum=True))
    data = b"".join(frames)
    plan = build_batch_plan(data)
    assert plan.n_lit_lanes >= 1280, plan.n_lit_lanes
    assert plan.n_seq_lanes >= 256, plan.n_seq_lanes
    return plan


def _capture_schedule(monkeypatch, plan, subset_lit, subset_seq):
    """Run both GPU dispatch paths with the kernels stubbed; return
    (block_steps, fetch_words) summed over the dispatched calls."""
    import zstd_tpu.kernels.triton_decode as td

    calls = []

    def lit_stub(words, lanes, cum, blk_steps, *banks, n_dense, **kw):
        calls.append((int(blk_steps.sum()), n_dense + lanes.shape[1]))
        return object()

    def seq_stub(words, lanes, cumw, blk_steps, *banks, n_dense_w, **kw):
        calls.append((int(blk_steps.sum()), n_dense_w + lanes.shape[1]))
        return object()

    monkeypatch.setattr(td, "decode_literals_gpu", lit_stub)
    monkeypatch.setattr(td, "decode_sequences_gpu", seq_stub)

    # The "kernel" route is the GPU dispatch (one call per phase, lanes
    # sorted into 16-lane blocks); the kernels themselves are stubbed.
    eng = DeviceEngine()
    eng._route_pin = "kernel"
    eng._put = lambda a, lane: np.asarray(a)
    eng._plan_dev = lambda plan: {
        k: None for k in ("words", "huff_flat", "fse_flat0", "fse_flat1", "fse_off")
    }
    eng._dispatch_literals(plan, subset=subset_lit)
    eng._dispatch_sequences(plan, subset=subset_seq)
    steps = sum(c[0] for c in calls)
    fetch_w = sum(c[1] for c in calls)
    return steps, fetch_w


def test_dispatched_work_shrinks_per_process(monkeypatch, big_plan):
    plan = big_plan
    base_steps, base_fetch = _capture_schedule(
        monkeypatch,
        plan,
        np.arange(plan.n_lit_lanes),
        np.arange(plan.n_seq_lanes),
    )
    assert base_steps > 0 and base_fetch > 0

    prev_max = (base_steps, base_fetch)
    for P in (2, 4, 8):
        lit_bins = shard_lanes_balanced(plan.lit_regen, P)
        seq_bins = shard_lanes_balanced(plan.seq_nseq, P)
        per_proc = [
            _capture_schedule(monkeypatch, plan, lit_bins[p], seq_bins[p])
            for p in range(P)
        ]
        worst_steps = max(s for s, _f in per_proc)
        worst_fetch = max(f for _s, f in per_proc)
        # The job finishes with the slowest process: its dispatched
        # block steps and fetched words must track ~1/P (tolerance
        # covers block and pow2 quantization and bin imbalance).
        assert worst_steps <= 1.5 * base_steps / P, (P, worst_steps, base_steps)
        assert worst_fetch <= 1.4 * base_fetch / P, (P, worst_fetch, base_fetch)
        # And the split must actually improve as P doubles.
        assert worst_steps < prev_max[0]
        assert worst_fetch < prev_max[1]
        prev_max = (worst_steps, worst_fetch)


def test_balanced_bins_cover_all_lanes(big_plan):
    plan = big_plan
    for P in (2, 4, 8):
        for key, n in (
            (plan.lit_regen, plan.n_lit_lanes),
            (plan.seq_nseq, plan.n_seq_lanes),
        ):
            bins = shard_lanes_balanced(key, P)
            seen = np.concatenate([np.asarray(b, dtype=np.int64) for b in bins])
            assert sorted(seen.tolist()) == list(range(n))
            work = np.array([int(key[b].sum()) for b in bins])
            assert work.max() <= 1.25 * max(work.mean(), 1)
