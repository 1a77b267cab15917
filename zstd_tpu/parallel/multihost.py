"""Multi-process (multi-host) distributed decode.

The SURVEY.md §2.3 "multi-host scheduler" made real: under
``jax.distributed.initialize`` every process runs the same program —

1. identical host prepass (the block table is deterministic),
2. ``shard_lanes_balanced`` splits the literal and sequence lane
   tables into per-process bins balanced by symbol count,
3. each process decodes only its bin with the shared v2 kernel
   dispatch (runtime/engine.py, lane-sharded over its local chips),
4. per-lane outputs are exchanged with an ordered fixed-shape
   all-gather across processes (pad-to-max + exact slicing of
   variable-length block outputs), and
5. every process assembles the full frame bytes identically.

The reference decodes everything on one thread
(/root/reference/src/main.rs:43-53); this module is the scale-out
axis it never had.
"""

from __future__ import annotations

import numpy as np

from ..format.frame import MAX_WINDOW_SIZE
from ..runtime.engine import DeviceEngine
from .dist import shard_lanes_balanced


def initialize(coordinator_address: str, num_processes: int, process_id: int) -> None:
    """Join the multi-process job (jax.distributed runtime).

    Call once per process before any JAX use; ``jax.process_count()``
    then reports the job size and the engine below auto-scatters.
    """
    import jax

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        cluster_detection_method="deactivate",
    )


def _allgather(arr: np.ndarray) -> np.ndarray:
    """Fixed-shape all-gather over processes: (P, *arr.shape)."""
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(arr, tiled=False))


class MultihostEngine(DeviceEngine):
    """DeviceEngine whose lane work is scattered over processes.

    Each process decodes a balanced bin of lanes locally (optionally
    lane-sharded over its local chips via ``local_mesh``), then bins
    are exchanged with ordered all-gathers; assembly and checksum
    verification run identically everywhere, so ``decompress`` returns
    the same bytes on every process.
    """

    def __init__(self, *, max_window_size: int = MAX_WINDOW_SIZE,
                 local_mesh=None, **kw):
        import jax

        super().__init__(max_window_size=max_window_size, mesh=local_mesh, **kw)
        self.nproc = jax.process_count()
        self.pid = jax.process_index()

    # -- scattered dispatch -------------------------------------------------

    def _run_both(self, plan):
        """Sequential per-phase form: each phase's cross-process
        exchange is a collective every process must enter in the same
        order, so the single-process batched-fetch overlap is skipped."""
        return self._run_literals(plan), self._run_sequences(plan)

    def _run_literals(self, plan):
        bins = shard_lanes_balanced(plan.lit_regen, self.nproc)
        outs, ok = self._run_literals_wide(plan, subset=bins[self.pid])
        self._exchange_literals(plan, bins, outs, ok)
        return outs, ok

    def _run_sequences(self, plan):
        bins = shard_lanes_balanced(plan.seq_nseq, self.nproc)
        outs, ok = self._run_sequences_wide(plan, subset=bins[self.pid])
        self._exchange_sequences(plan, bins, outs, ok)
        return outs, ok

    # -- ordered exchange ---------------------------------------------------
    #
    # All processes know every bin and every per-lane size from the
    # (identical) plan, so buffers are fixed-shape: each process packs
    # its bin's outputs into a pad-to-max flat buffer, one all-gather
    # moves them, and exact slicing restores per-lane arrays in order.

    def _exchange_literals(self, plan, bins, outs, ok) -> None:
        sizes = [int(plan.lit_regen[b].sum()) for b in bins]
        width = max(max(sizes), 1)
        buf = np.zeros(width, dtype=np.uint8)
        pos = 0
        for lane in bins[self.pid]:
            r = int(plan.lit_regen[lane])
            if r and outs[lane] is not None:
                buf[pos : pos + r] = outs[lane]
            pos += r
        okbuf = np.zeros(max(len(b) for b in bins) + 1, dtype=bool)
        okbuf[: len(bins[self.pid])] = ok[bins[self.pid]]
        gathered = _allgather(buf)
        ok_g = _allgather(okbuf)
        for p, b in enumerate(bins):
            if p == self.pid:
                continue
            pos = 0
            for k, lane in enumerate(b):
                r = int(plan.lit_regen[lane])
                outs[lane] = gathered[p, pos : pos + r]
                ok[lane] = ok_g[p, k]
                pos += r

    def _exchange_sequences(self, plan, bins, outs, ok) -> None:
        sizes = [int(plan.seq_nseq[b].sum()) for b in bins]
        width = max(max(sizes), 1)
        # Rows: ll (int32), ofv (uint32 viewed int32), ml (int32).
        buf = np.zeros((3, width), dtype=np.int64)
        pos = 0
        for lane in bins[self.pid]:
            ns = int(plan.seq_nseq[lane])
            if ns and outs[lane] is not None:
                ll, ofv, ml = outs[lane]
                got = len(ll)  # may be < ns when the lane failed
                buf[0, pos : pos + got] = ll
                buf[1, pos : pos + got] = ofv.astype(np.int64)
                buf[2, pos : pos + got] = ml
            pos += ns
        okbuf = np.zeros(max(len(b) for b in bins) + 1, dtype=bool)
        okbuf[: len(bins[self.pid])] = ok[bins[self.pid]]
        gathered = _allgather(buf)
        ok_g = _allgather(okbuf)
        for p, b in enumerate(bins):
            if p == self.pid:
                continue
            pos = 0
            for k, lane in enumerate(b):
                ns = int(plan.seq_nseq[lane])
                outs[lane] = (
                    gathered[p, 0, pos : pos + ns],
                    gathered[p, 1, pos : pos + ns].astype(np.uint64),
                    gathered[p, 2, pos : pos + ns],
                )
                ok[lane] = ok_g[p, k]
                pos += ns


def multihost_decompress(data: bytes, *, max_window_size=None, **kw) -> bytes:
    """Decode ``data`` cooperatively across all processes of the job.

    Returns the full output bytes on every process (identical)."""
    engine = MultihostEngine(
        max_window_size=max_window_size or MAX_WINDOW_SIZE, **kw
    )
    return engine.decompress(data)
