"""Single-device decode engine: host prepass -> batched device entropy
kernels -> host assembly.

Pipeline (SURVEY.md §7):

1. ``build_batch_plan`` parses frames and lays each entropy stream out
   as a kernel lane; the single-device path plans ~1 MiB frame GROUPS
   and dispatches each group as soon as it parses, so the prepass of
   group k overlaps the device execution of groups < k
   (``_iter_pipelined``); each group assembles as soon as its
   fetches land, overlapping later groups' transfers.
2. Each phase (literals, sequences) is one kernel launch per group on
   a GPU (kernels/triton_decode.py: every lane runs its whole loop);
   elsewhere, and under a mesh, the lax.scan forms
   (kernels/entropy2.py) run in a few pow2-step calls (``_tier_split``).
   ALL calls of BOTH phases dispatch asynchronously, then each call's
   output streams back in dispatch order (``_fetch_stream``;
   ``measure_phases`` uses a barrier + one batched ``_fetch_tree``
   instead).
3. Both kernel families write dense outputs (only real symbols and
   word-packed triples, then per-lane ok flags); a wide-format retry on
   the scan form covers packed-range overflow lanes.
4. Frames are stitched in order on the host: raw/RLE copies, literal
   stream concatenation, repeat-offset resolution + LZ77 execution
   (C executor by default, pure-device optional), checksum
   verification.

Any lane whose kernel status fails — and any frame the prepass flagged —
is re-decoded by the host oracle, so the engine's output is bit-exact by
construction.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

import numpy as np

from ..format.block import BlockType
from ..format.block_table import BatchPlan, BlockPlan, FramePlan, build_batch_plan
from ..format.frame import MAX_WINDOW_SIZE, SkippableFrame
from ..format.literals import LiteralsType
from ..ops.lz77 import execute_sequences
from ..ops.sequence_codes import INITIAL_REPEAT_OFFSETS
from ..utils.errors import ChecksumMismatch, ImpossibleValue
from ..utils.xxh64 import xxh64
from .oracle import decode_frame

_log = logging.getLogger(__name__)


def _next_pow2(n: int, lo: int = 8) -> int:
    n = max(n, lo)
    return 1 << (n - 1).bit_length()


def _dense_pad(n: int, lo: int = 256) -> int:
    """Pad a dense output length to a sixteenth-pow2 ladder.

    Rounding up to a multiple of 2^(bits-4) caps the fetched padding at
    12.5% (pow2 padding would waste up to 2x) for a 16-shapes-per-octave
    jit family.  Not measured on a GPU yet."""
    n = max(n, lo)
    p = 1 << max((n - 1).bit_length() - 4, 0)
    return -(-n // p) * p


@dataclass
class EngineStats:
    """Per-run observability counters (SURVEY.md §5 metrics)."""

    bytes_in: int = 0
    bytes_out: int = 0
    frames: int = 0
    blocks: int = 0
    lit_lanes: int = 0
    seq_lanes: int = 0
    fallback_frames: int = 0
    fallback_reasons: list = field(default_factory=list)
    kernel_calls: int = 0
    upload_bytes: int = 0
    fetch_bytes: int = 0
    wall_s: dict = field(default_factory=dict)

    def as_dict(self) -> dict:
        return {
            "bytes_in": self.bytes_in,
            "bytes_out": self.bytes_out,
            "frames": self.frames,
            "blocks": self.blocks,
            "lit_lanes": self.lit_lanes,
            "seq_lanes": self.seq_lanes,
            "fallback_frames": self.fallback_frames,
            "fallback_reasons": list(self.fallback_reasons),
            "kernel_calls": self.kernel_calls,
            "upload_bytes": self.upload_bytes,
            "fetch_bytes": self.fetch_bytes,
            "wall_s": dict(self.wall_s),
        }


class DeviceEngine:
    """Batched decoder over the default JAX device (GPU or CPU)."""

    def __init__(
        self,
        *,
        max_window_size: int = MAX_WINDOW_SIZE,
        device_execute: bool = False,
        mesh=None,
    ):
        from .jaxcache import enable_compilation_cache

        enable_compilation_cache()
        self.max_window_size = max_window_size
        # Pure-device LZ77 execution (kernels/lz77_device.py) instead of
        # the native C executor — see that module for the tradeoff.
        self.device_execute = device_execute
        # Kernel family, resolved by ``_route``: None picks the Triton
        # kernels on a GPU without a mesh and the lax.scan forms
        # otherwise.  Tests pin "interpret" (the Triton kernels in
        # Pallas interpret mode) or "scan"; users have no such option.
        self._route_pin: str | None = None
        # Optional jax.sharding.Mesh with a pow2 device count <= 128:
        # lane arrays are sharded over its "lanes" axis and the lax.scan
        # kernels run GSPMD — the single-device and sharded paths share
        # every line of dispatch (SURVEY.md §2.3 DP).
        self.mesh = mesh
        # When set, _run_both inserts a block_until_ready barrier
        # between dispatch and fetch and records the phase split
        # (dispatch / device compute / fetch) in stats.wall_s — a
        # measurement mode: the barrier stops the fetch from
        # overlapping residual device compute, so leave it off in
        # production paths.
        self.measure_phases = False
        self._upload_track: list = []
        self.stats = EngineStats()

    # -- array placement (mesh-aware; multihost overrides in parallel/) -----

    def _put(self, a, *, lane: bool):
        """Device placement: lane arrays shard over the mesh's lane
        axis (axis 0), everything else (words, scalars) replicates."""
        import jax.numpy as jnp

        x = jnp.asarray(a)
        self.stats.upload_bytes += int(x.nbytes)
        if self.measure_phases:
            self._upload_track.append(x)
        if self.mesh is None:
            return x
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        from ..parallel.mesh import LANE_AXIS

        spec = P(LANE_AXIS, *([None] * (x.ndim - 1))) if lane else P()
        return jax.device_put(x, NamedSharding(self.mesh, spec))

    def _fetch(self, x) -> np.ndarray:
        """Materialize a (possibly lane-sharded) kernel output on host."""
        return np.asarray(x)

    def _fetch_tree(self, xs) -> list:
        """Materialize several outputs at once (one batched
        jax.device_get)."""
        import jax

        out = [np.asarray(a) for a in jax.device_get(list(xs))]
        self.stats.fetch_bytes += sum(int(a.nbytes) for a in out)
        return out

    def _fetch_stream(self, xs):
        """Yield each call's fetched output in dispatch order, with the
        fetches running on a small thread pool: the transfer of call k
        overlaps both the device compute of calls k+1.. (the device
        executes in dispatch order) and the host-side finish work on
        already-fetched calls.  The pool's two workers were sized for a
        slow remote link; their worth over a plain serial fetch is not
        measured on a GPU yet."""
        import jax

        handles = list(xs)
        if len(handles) <= 1:
            return iter(self._fetch_tree(handles))
        if getattr(self, "_fetch_pool", None) is None:
            from concurrent.futures import ThreadPoolExecutor

            self._fetch_pool = ThreadPoolExecutor(
                max_workers=2, thread_name_prefix="zt-fetch"
            )
        futs = [
            self._fetch_pool.submit(lambda h=h: np.asarray(jax.device_get(h)))
            for h in handles
        ]
        # Tracked so an abandoned generator (worker exception → oracle
        # fallback) can be drained: a stale in-flight fetch would
        # otherwise occupy both workers into the next decompress.
        self._fetch_futs = futs

        def gen():
            for f in futs:
                a = f.result()
                self.stats.fetch_bytes += int(a.nbytes)
                yield a

        return gen()

    def _drain_fetches(self) -> None:
        """Cancel queued fetch futures and wait out running ones, so a
        fallback path leaves the pool idle for the next decompress."""
        for f in getattr(self, "_fetch_futs", ()):
            if not f.cancel():
                try:
                    f.result()
                except Exception:
                    pass
        self._fetch_futs = []

    def close(self) -> None:
        """Release the fetch thread pool (idempotent)."""
        pool = getattr(self, "_fetch_pool", None)
        if pool is not None:
            pool.shutdown(wait=False, cancel_futures=True)
            self._fetch_pool = None

    def _plan_dev(self, plan) -> dict:
        """Per-plan device residents, uploaded once per decompress: the
        u32 words buffer (the largest input) and the FSE/Huffman table
        BANKS, from which kernels read per-lane table rows on-device.
        The Triton kernels also get flat Huffman tables.  Bank row
        counts pad to pow2 to bound the jit shape family."""
        if getattr(self, "_dev_cache", None) is None or self._dev_cache[0] is not plan:
            # _early_words is the whole-input upload issued at
            # decompress entry; it persists for the run so every
            # frame-group plan of a pipelined decompress shares it
            # (absolute word indexing — block_table._StreamLocator).
            words_dev = getattr(self, "_early_words", None)
            if words_dev is None:
                words_dev = self._put(plan.words, lane=False)

            def bank(a, lo):
                rows = _next_pow2(a.shape[0], lo=lo)
                if rows != a.shape[0]:
                    a = np.pad(a, ((0, rows - a.shape[0]), (0, 0)))
                return self._put(a, lane=False)

            def flat(a):
                n = _dense_pad(len(a), lo=64)
                if n != len(a):
                    a = np.pad(a, (0, n - len(a)))
                return self._put(a, lane=False)

            dev = {
                "words": words_dev,
                "fse_flat0": flat(plan.fse_flat0),
                "fse_flat1": flat(plan.fse_flat1),
                "fse_off": self._put(
                    np.pad(
                        plan.fse_off,
                        (0, _next_pow2(len(plan.fse_off), lo=8) - len(plan.fse_off)),
                    ),
                    lane=False,
                ),
                "limits": bank(plan.huff_limits, 4),
                "prevs": bank(plan.huff_prevs, 4),
                "lengths": bank(plan.huff_lengths, 4),
                "rankb": bank(plan.huff_rankb, 4),
                "ranked": bank(plan.huff_ranked, 4),
            }
            if self._route() != "scan":
                from ..kernels.triton_decode import huffman_flat

                flat = huffman_flat(
                    plan.huff_limits, plan.huff_prevs, plan.huff_lengths,
                    plan.huff_rankb, plan.huff_ranked,
                )
                rows = _next_pow2(flat.shape[0], lo=4)
                flat = np.pad(flat, ((0, rows - flat.shape[0]), (0, 0)))
                dev["huff_flat"] = self._put(flat.reshape(-1), lane=False)
            self._dev_cache = (plan, dev)
        return self._dev_cache[1]

    def _words_dev(self, plan):
        return self._plan_dev(plan)["words"]

    def _pad_lanes(self, idx: np.ndarray) -> np.ndarray:
        """Mesh-aware lane rows for the scan form (see ``_pad_pow2``):
        at least 32 rows (a floor chosen to bound fetched padding over a
        slow remote link; not measured on a GPU yet) and divisible by
        the mesh's device count.  On a mesh, device d's block of rows
        holds real lanes d, d + n, d + 2n, ... so every device gets an
        equal share of the real lanes, never just the first device."""
        if self.mesh is None:
            return _pad_pow2(idx, lo=32)
        n = int(self.mesh.devices.size)
        rows = _pad_pow2(idx, lo=max(32, n))
        i = np.arange(len(idx))
        spread = np.full(len(rows), -1, dtype=np.int64)
        spread[(i % n) * (len(rows) // n) + i // n] = idx
        return spread

    def _seq_pack_meta(self, plan, sel, nseq):
        """Per-call packed-triple metadata: table-bounded field widths
        and word-count prefix sums for the word-granular pack (see
        kernels/entropy2._pack_triples — each sequence takes 1 whole
        u32 word, 2 when the width sum exceeds 32).  w_of is clamped so
        a sequence packs into <= 63 bits — legit offsets are bounded by
        the window (<= 24 bits), and a clamped-out value flags the lane
        to the wide retry rather than truncating."""
        w_ll = plan.fse_wbits[plan.seq_ll_slot[sel]].astype(np.int32)
        w_ml = plan.fse_wbits[plan.seq_ml_slot[sel]].astype(np.int32)
        w_of = plan.fse_wbits[plan.seq_of_slot[sel]].astype(np.int32)
        w_of = np.minimum(w_of, 63 - w_ll - w_ml)
        g = 1 + (w_ll + w_ml + w_of > 32)
        wc = nseq.astype(np.int64) * g
        cumw = np.zeros(len(sel) + 1, dtype=np.int32)
        np.cumsum(wc, out=cumw[1:])
        n_dense_w = _dense_pad(int(cumw[-1]))
        return w_ll, w_ml, w_of, cumw, n_dense_w

    def _seq_lane_mat(self, plan, sel, nseq, w_ll, w_ml, w_of) -> np.ndarray:
        """Stacked (L, 13) per-lane columns (entropy2.SEQ_LANE_COLS) —
        one upload per call instead of 13 small arrays."""
        return np.stack(
            [
                plan.seq_base[sel],
                plan.seq_p0[sel],
                plan.seq_pend[sel],
                nseq,
                w_ll,
                w_ml,
                w_of,
                plan.seq_ll_slot[sel],
                plan.seq_of_slot[sel],
                plan.seq_ml_slot[sel],
                plan.seq_ll_al[sel],
                plan.seq_of_al[sel],
                plan.seq_ml_al[sel],
            ],
            axis=1,
        ).astype(np.int32)

    def _route(self) -> str:
        """Kernel family for this engine: "kernel" (the Triton kernels,
        on a GPU without a mesh), "scan" (the lax.scan forms) or a
        test's pin (see __init__)."""
        if self._route_pin is not None:
            return self._route_pin
        if self.mesh is not None:
            return "scan"
        import jax

        return "kernel" if jax.default_backend() == "gpu" else "scan"

    # -- kernel dispatch ----------------------------------------------------

    def _run_literals(self, plan: BatchPlan):
        return self._run_literals_wide(plan)

    def _run_sequences(self, plan: BatchPlan):
        return self._run_sequences_wide(plan)

    def _run_both(self, plan: BatchPlan):
        """Dispatch BOTH phases' kernel calls before fetching anything,
        then stream each call's output back in dispatch order on a
        2-worker fetch pool (``_fetch_stream``): the transfer of call k
        overlaps the device compute of later calls and the host
        finish work on earlier ones.  In ``measure_phases`` mode the
        streaming is replaced by a block_until_ready barrier plus one
        batched ``_fetch_tree`` so the dispatch / device-compute /
        fetch phase split is observable.  Subclasses with their own
        phase plumbing (parallel/multihost.py) override this to the
        sequential per-phase form.
        """
        if self.measure_phases:
            import time

            import jax

            t0 = time.perf_counter()
            lit_outs, lit_ok, lp = self._dispatch_literals(plan)
            seq_outs, seq_ok, sp = self._dispatch_sequences(plan)
            handles = _handles(lp) + _handles(sp)
            t1 = time.perf_counter()
            # Block on the INPUT uploads first, then on the kernel
            # outputs: splits device time into the host-to-device
            # upload tail and the residual device compute.  Kernels
            # overlap late uploads, so the residual is a lower bound on
            # pure compute, and upload_wait correspondingly an upper
            # bound on the transfer share.
            jax.block_until_ready(self._upload_track)
            tu = time.perf_counter()
            jax.block_until_ready(handles)
            t2 = time.perf_counter()
            it = iter(self._fetch_tree(handles))
            t3 = time.perf_counter()
            self.stats.wall_s["dispatch"] = t1 - t0
            self.stats.wall_s["upload_wait"] = tu - t1
            self.stats.wall_s["device_compute"] = t2 - tu
            self.stats.wall_s["fetch"] = t3 - t2
        else:
            lit_outs, lit_ok, lp = self._dispatch_literals(plan)
            seq_outs, seq_ok, sp = self._dispatch_sequences(plan)
            it = self._fetch_stream(_handles(lp) + _handles(sp))
        self._finish_literals(plan, lp, lit_outs, lit_ok, it)
        self._finish_sequences(plan, sp, seq_outs, seq_ok, it)
        self._retry_sequences(plan, seq_outs, seq_ok)
        return (lit_outs, lit_ok), (seq_outs, seq_ok)

    def _call_sequences(
        self,
        plan: BatchPlan,
        rows: np.ndarray,
        steps: int,
        wide: bool = False,
    ):
        """One v2 sequences kernel call over the lane ``rows``."""
        from ..kernels.entropy2 import decode_sequences_v2

        sel = np.maximum(rows, 0)
        nseq = np.where(rows >= 0, plan.seq_nseq[sel], 0).astype(np.int32)
        ll0, ll1 = plan.fse_rows(plan.seq_ll_slot[sel])
        of0, of1 = plan.fse_rows(plan.seq_of_slot[sel])
        ml0, ml1 = plan.fse_rows(plan.seq_ml_slot[sel])
        lane = lambda a: self._put(a, lane=True)  # noqa: E731
        res = decode_sequences_v2(
            self._words_dev(plan),
            lane(plan.seq_base[sel]),
            lane(plan.seq_p0[sel]),
            lane(plan.seq_pend[sel]),
            lane(nseq),
            lane(ll0),
            lane(ll1),
            lane(of0),
            lane(of1),
            lane(ml0),
            lane(ml1),
            lane(plan.seq_ll_al[sel]),
            lane(plan.seq_of_al[sel]),
            lane(plan.seq_ml_al[sel]),
            max_steps=steps,
            wide=wide,
        )
        self.stats.kernel_calls += 1
        return res

    def _run_literals_wide(self, plan: BatchPlan, subset=None):
        outs, ok, pending = self._dispatch_literals(plan, subset)
        it = self._fetch_stream(_handles(pending))
        self._finish_literals(plan, pending, outs, ok, it)
        return outs, ok

    def _run_sequences_wide(self, plan: BatchPlan, subset=None):
        outs, ok, pending = self._dispatch_sequences(plan, subset)
        it = self._fetch_stream(_handles(pending))
        self._finish_sequences(plan, pending, outs, ok, it)
        self._retry_sequences(plan, outs, ok)
        return outs, ok

    def _dispatch_literals(self, plan: BatchPlan, subset=None):
        """Dispatch the dense literals kernel over all lanes: one Triton
        call on a GPU, else the lax.scan form in pow2-step tiers.
        Literal step counts are exact (the scan never stalls: refill
        inflow 32 bits per 2 symbols >= max outflow 22 bits), so no
        retry pass is needed.

        ``subset``: decode only these lane indices (multihost binning,
        parallel/multihost.py); other lanes stay (None, ok=True) for
        the exchange step to fill.  Returns (outs, ok, pending).
        """
        from ..kernels.entropy2 import LIT_SYMS_PER_STEP

        n = plan.n_lit_lanes
        outs: list[np.ndarray | None] = [None] * n
        ok = np.ones(n, dtype=bool)
        pending: list[tuple] = []
        if n == 0:
            return outs, ok, pending
        regen = _subset_need(plan.lit_regen, subset)
        route = self._route()
        if route != "scan":
            from ..kernels.triton_decode import LANE_BLOCK, decode_literals_gpu

            rows, blk_steps = _kernel_lanes(-(-regen // 4), LANE_BLOCK)
            if not len(rows):
                return outs, ok, pending
            lane_mat, cum, n_dense = self._lit_call_inputs(plan, rows)
            dev = self._plan_dev(plan)
            handle = decode_literals_gpu(
                dev["words"],
                self._put(np.ascontiguousarray(lane_mat.T), lane=False),
                self._put(cum, lane=False),
                self._put(blk_steps, lane=False),
                dev["huff_flat"],
                n_dense=n_dense,
                interpret=route == "interpret",
            )
            self.stats.kernel_calls += 1
            pending.append((rows, cum, handle))
            return outs, ok, pending
        from ..kernels.entropy2 import decode_literals_dense

        ceil_steps = -(-regen // LIT_SYMS_PER_STEP)
        for idx, steps in _tier_split(ceil_steps, lo=4):
            rows = self._pad_lanes(idx)
            lane_mat, cum, n_dense = self._lit_call_inputs(plan, rows)
            dev = self._plan_dev(plan)
            handle = decode_literals_dense(
                dev["words"],
                self._put(lane_mat, lane=True),
                self._put(cum, lane=False),
                dev["limits"],
                dev["prevs"],
                dev["lengths"],
                dev["rankb"],
                dev["ranked"],
                max_steps=steps,
                n_dense=n_dense,
            )
            self.stats.kernel_calls += 1
            pending.append((rows, cum, handle))
        return outs, ok, pending

    def _lit_call_inputs(self, plan, rows):
        """(L, 5) per-lane columns (entropy2.LIT_LANE_COLS, padding
        rows with zero regen), word-count prefix sums and the dense
        output length for one literals call over lane ``rows``."""
        sel = np.maximum(rows, 0)
        regen = np.where(rows >= 0, plan.lit_regen[sel], 0).astype(np.int32)
        cum = np.zeros(len(sel) + 1, dtype=np.int32)
        np.cumsum(-(-regen // 4), out=cum[1:])
        lane_mat = np.stack(
            [
                plan.lit_base[sel],
                plan.lit_p0[sel],
                plan.lit_pend[sel],
                regen,
                plan.lit_slot[sel],
            ],
            axis=1,
        ).astype(np.int32)
        return lane_mat, cum, _dense_pad(int(cum[-1]))

    def _dispatch_sequences(self, plan: BatchPlan, subset=None):
        """Dispatch the dense sequences kernel: one Triton call on a
        GPU, else the lax.scan form in at most two pow2-step tiers (its
        step counts are exact by the never-stall invariant,
        kernels/entropy2.py).  The fetch is word-packed — 4 B per real
        sequence (8 B when the field-width sum exceeds 32;
        ``_seq_pack_meta``).  Returns (outs, ok, pending)."""
        from ..kernels.entropy2 import SEQ_SLOTS_PER_STEP, decode_sequences_dense

        n = plan.n_seq_lanes
        outs: list[tuple | None] = [None] * n
        ok = np.ones(n, dtype=bool)
        pending: list[tuple] = []
        if n == 0:
            return outs, ok, pending
        need = _subset_need(plan.seq_nseq, subset)
        route = self._route()
        if route != "scan":
            from ..kernels.triton_decode import LANE_BLOCK, decode_sequences_gpu

            rows, blk_steps = _kernel_lanes(need, LANE_BLOCK)
            if not len(rows):
                return outs, ok, pending
            groups = [(rows, blk_steps)]
        else:
            groups = [
                (self._pad_lanes(idx), steps)
                for idx, steps in _tier_split(
                    -(-need // SEQ_SLOTS_PER_STEP), lo=2, max_calls=2
                )
            ]
        for rows, steps in groups:
            sel = np.maximum(rows, 0)
            nseq = np.where(rows >= 0, plan.seq_nseq[sel], 0).astype(np.int32)
            w_ll, w_ml, w_of, cumw, n_dense_w = self._seq_pack_meta(
                plan, sel, nseq
            )
            lane_mat = self._seq_lane_mat(plan, sel, nseq, w_ll, w_ml, w_of)
            dev = self._plan_dev(plan)
            banks = (dev["fse_flat0"], dev["fse_flat1"], dev["fse_off"])
            if route != "scan":
                handle = decode_sequences_gpu(
                    dev["words"],
                    self._put(np.ascontiguousarray(lane_mat.T), lane=False),
                    self._put(cumw, lane=False),
                    self._put(steps, lane=False),
                    *banks,
                    n_dense_w=n_dense_w,
                    interpret=route == "interpret",
                )
            else:
                handle = decode_sequences_dense(
                    dev["words"],
                    self._put(lane_mat, lane=True),
                    self._put(cumw, lane=False),
                    *banks,
                    max_steps=steps,
                    n_dense_w=n_dense_w,
                )
            self.stats.kernel_calls += 1
            pending.append((rows, cumw, handle))
        return outs, ok, pending

    def _finish_literals(self, plan, pending, outs, ok, fetched) -> None:
        # Each pending call fetched ONE packed uint32 array:
        # dense words (n_dense) then per-lane ok flags (len(cum) - 1)
        # — the kernels concatenate so each call costs one round-trip
        # (kernels/entropy2.py decode_literals_dense).
        # Row j of a call is lane rows[j], or padding when rows[j] < 0.
        for rows, cum, _handles_ in pending:
            arr = next(fetched)
            n_dense = arr.size - (len(cum) - 1)
            dense, lane_ok = arr[:n_dense], arr[n_dense:].astype(bool)
            flat = dense.view(np.uint8)
            for j, lane in enumerate(rows):
                if lane < 0:
                    continue
                start = 4 * int(cum[j])
                outs[lane] = flat[start : start + plan.lit_regen[lane]]
                ok[lane] = lane_ok[j]

    def _finish_sequences(self, plan, pending, outs, ok, fetched) -> None:
        # One uint32 array per call: word-packed triple streams
        # (n_dense_w words) ‖ per-lane ok flags — see
        # decode_sequences_dense / _pack_triples.  Prefix validity is
        # the kernel's job (a stall flags the lane bad); packing
        # overflow also lands in the ok flag, so every not-ok lane
        # re-decodes on the wide path.
        wb = plan.fse_wbits
        one = np.uint64(1)
        for rows, cumw, _handles_ in pending:
            arr = next(fetched)
            n_dense_w = arr.size - (len(cumw) - 1)
            packed = np.concatenate(
                [arr[:n_dense_w], np.zeros(2, np.uint32)]
            ).astype(np.uint64)
            real = np.flatnonzero(rows >= 0)
            idx = rows[real]
            ok[idx] = arr[n_dense_w:].astype(bool)[real]
            # One vectorized unpack across ALL lanes of the call: the
            # pack is word-granular (entropy2._pack_triples), so
            # sequence i of lane j sits at word cumw[j] + i*g_j (plus a
            # high word when g_j = 2) — a pure array read, no bit-
            # position arithmetic.
            ns = plan.seq_nseq[idx].astype(np.int64)
            tot = int(ns.sum())
            if tot == 0:
                for lane in idx:
                    outs[lane] = (
                        np.empty(0, np.int32),
                        np.empty(0, np.uint32),
                        np.empty(0, np.int32),
                    )
                continue
            w_ll = wb[plan.seq_ll_slot[idx]].astype(np.int64)
            w_ml = wb[plan.seq_ml_slot[idx]].astype(np.int64)
            w_of = np.minimum(
                wb[plan.seq_of_slot[idx]].astype(np.int64), 63 - w_ll - w_ml
            )
            w = w_ll + w_ml + w_of
            g = 1 + (w > 32).astype(np.int64)
            starts = np.zeros(len(idx) + 1, dtype=np.int64)
            np.cumsum(ns, out=starts[1:])
            lane_rep = np.repeat(np.arange(len(idx)), ns)
            i_local = np.arange(tot, dtype=np.int64) - starts[lane_rep]
            wi = cumw[real].astype(np.int64)[lane_rep] + i_local * g[lane_rep]
            v = packed[wi] | np.where(
                g[lane_rep] == 2, packed[wi + 1], np.uint64(0)
            ) << np.uint64(32)
            wr = w[lane_rep].astype(np.uint64)
            v &= (one << wr) - one
            wllr = w_ll[lane_rep].astype(np.uint64)
            wmlr = w_ml[lane_rep].astype(np.uint64)
            vll = (v & ((one << wllr) - one)).astype(np.int32)
            vof = (v >> (wllr + wmlr)).astype(np.uint32)
            vml = ((v >> wllr) & ((one << wmlr) - one)).astype(np.int32)
            for j, lane in enumerate(idx):
                s, e = starts[j], starts[j + 1]
                outs[lane] = (vll[s:e], vof[s:e], vml[s:e])

    def _retry_sequences(self, plan: BatchPlan, outs, ok) -> None:
        """Re-decode packed-range-overflow lanes (offset code >= 31, or
        a single >64 KiB literal run / match) on the wide kernel."""
        from ..kernels.entropy2 import SEQ_SLOTS_PER_STEP

        n = plan.n_seq_lanes
        failed = np.flatnonzero(~ok[:n] & (plan.seq_nseq > 0))
        if not failed.size:
            return
        need = -(-plan.seq_nseq[failed] // SEQ_SLOTS_PER_STEP)
        steps = _next_pow2(int(need.max()), lo=2)
        rows = self._pad_lanes(failed)
        ok[failed] = True
        res = self._call_sequences(plan, rows, steps, wide=True)
        self._unpack_sequences_wide(plan, rows, res, outs, ok)

    def _unpack_sequences_wide(self, plan: BatchPlan, rows, res, outs, ok) -> None:
        pa, vll_p, vml_p, lane_ok = self._fetch_tree(res)

        def to_flat(h):
            return np.ascontiguousarray(h.transpose(2, 0, 1)).reshape(h.shape[2], -1)

        pa = to_flat(pa)
        valid = pa >> 31
        ofv = pa & np.uint32(0x7FFFFFFF)
        vll, vml = to_flat(vll_p), to_flat(vml_p)
        for j, lane in enumerate(rows):
            if lane < 0:
                continue
            mask = valid[j].astype(bool)
            ns = plan.seq_nseq[lane]
            lls = vll[j][mask][:ns]
            outs[lane] = (lls, ofv[j][mask][:ns], vml[j][mask][:ns])
            ok[lane] = lane_ok[j] and len(lls) == ns

    # -- assembly -----------------------------------------------------------

    def _assemble_frame(self, fp: FramePlan, lit_outs, seq_outs) -> bytes | bytearray:
        """Assemble one frame's output.

        With the native runtime available: exact-size preallocation
        (block sizes are known once the sequence triples are decoded)
        and memcpy-chunked execution in C.  Otherwise: pure-Python path.
        With ``device_execute``: the pointer-doubling device kernel.
        """
        if self.device_execute:
            return self._assemble_frame_device(fp, lit_outs, seq_outs)
        try:
            from .. import native

            if not native.available():
                raise ImportError
        except ImportError:
            out = bytearray()
            rep = list(INITIAL_REPEAT_OFFSETS)
            for bp in fp.blocks:
                self._assemble_block(bp, out, rep, lit_outs, seq_outs)
            return out

        total = 0
        for bp in fp.blocks:
            if bp.kind == BlockType.RAW:
                total += len(bp.raw)
            elif bp.kind == BlockType.RLE:
                total += bp.rle_repeat
            else:
                total += bp.lit_regen
                if bp.seq_lane >= 0:
                    total += int(seq_outs[bp.seq_lane][2].sum())

        out = np.empty(total, dtype=np.uint8)
        out_len = 0
        rep = np.asarray(INITIAL_REPEAT_OFFSETS, dtype=np.uint64)
        for bp in fp.blocks:
            if bp.kind == BlockType.RAW:
                n = len(bp.raw)
                out[out_len : out_len + n] = np.frombuffer(bp.raw, dtype=np.uint8)
                out_len += n
                continue
            if bp.kind == BlockType.RLE:
                out[out_len : out_len + bp.rle_repeat] = bp.rle_byte
                out_len += bp.rle_repeat
                continue
            if bp.lit_kind == LiteralsType.RAW:
                literals = np.frombuffer(bp.lit_raw, dtype=np.uint8)
            elif bp.lit_kind == LiteralsType.RLE:
                literals = np.full(bp.lit_regen, bp.lit_rle_byte, dtype=np.uint8)
            else:
                parts = [
                    lit_outs[ref.lane] for ref in bp.lit_streams if ref.regen
                ]
                literals = (
                    np.concatenate(parts) if parts else np.empty(0, dtype=np.uint8)
                )
                if literals.size != bp.lit_regen:
                    raise ImpossibleValue("literal stream size mismatch")
            if bp.seq_lane < 0:
                out[out_len : out_len + literals.size] = literals
                out_len += literals.size
                continue
            ll, ofv, ml = seq_outs[bp.seq_lane]
            try:
                out_len = native.execute_sequences(
                    out, out_len, literals, ll, ofv, ml, rep
                )
            except ValueError as e:
                raise ImpossibleValue(str(e)) from None
        return memoryview(out)[:out_len]

    def _assemble_frame_device(self, fp: FramePlan, lit_outs, seq_outs):
        """Pure-device execution: build per-block source-map programs and
        run the pointer-doubling kernel (kernels/lz77_device.py)."""
        from ..kernels.lz77_device import build_source_map, execute_frame_on_device

        programs = []
        rep = list(INITIAL_REPEAT_OFFSETS)
        out_base = 0
        for bp in fp.blocks:
            if bp.kind == BlockType.RAW:
                arr = np.frombuffer(bp.raw, dtype=np.uint8)
                programs.append(("bytes", arr))
                out_base += len(arr)
                continue
            if bp.kind == BlockType.RLE:
                programs.append(
                    ("bytes", np.full(bp.rle_repeat, bp.rle_byte, dtype=np.uint8))
                )
                out_base += bp.rle_repeat
                continue
            if bp.lit_kind == LiteralsType.RAW:
                literals = np.frombuffer(bp.lit_raw, dtype=np.uint8)
            elif bp.lit_kind == LiteralsType.RLE:
                literals = np.full(bp.lit_regen, bp.lit_rle_byte, dtype=np.uint8)
            else:
                parts = [lit_outs[r.lane] for r in bp.lit_streams if r.regen]
                literals = (
                    np.concatenate(parts) if parts else np.empty(0, np.uint8)
                )
            if bp.seq_lane < 0:
                programs.append(("bytes", literals))
                out_base += len(literals)
                continue
            ll, ofv, ml = seq_outs[bp.seq_lane]
            src, total = build_source_map(ll, ofv, ml, len(literals), rep, out_base)
            # Every match byte must reference already-materialized output.
            match_srcs = src[src >= 0]
            if match_srcs.size and (
                match_srcs.min() < 0
                or (match_srcs >= out_base + np.flatnonzero(src >= 0)).any()
            ):
                raise ImpossibleValue("match references future or pre-frame data")
            programs.append(("seq", (src, literals)))
            out_base += total
        return execute_frame_on_device(programs)

    def _assemble_block(
        self,
        bp: BlockPlan,
        out: bytearray,
        rep: list[int],
        lit_outs,
        seq_outs,
    ) -> None:
        if bp.kind == BlockType.RAW:
            out += bp.raw
            return
        if bp.kind == BlockType.RLE:
            out += bytes([bp.rle_byte]) * bp.rle_repeat
            return

        # Compressed block: literals.
        if bp.lit_kind == LiteralsType.RAW:
            literals = bp.lit_raw
        elif bp.lit_kind == LiteralsType.RLE:
            literals = bytes([bp.lit_rle_byte]) * bp.lit_regen
        else:
            parts = [
                lit_outs[ref.lane].tobytes() if ref.regen else b""
                for ref in bp.lit_streams
            ]
            literals = b"".join(parts)
            if len(literals) != bp.lit_regen:
                raise ImpossibleValue("literal stream size mismatch")

        if bp.seq_lane < 0:
            out += literals
            return
        ll, ofv, ml = seq_outs[bp.seq_lane]
        triples = list(zip(ll.tolist(), ofv.tolist(), ml.tolist()))
        execute_sequences(out, triples, literals, rep)

    def decompress_with_stats(
        self,
        data: bytes | memoryview,
        *,
        verify_checksum: bool = True,
        include_skippable: bool = False,
    ) -> bytes:
        import time

        from ..format.block_table import input_words

        stats = self.stats = EngineStats()
        stats.bytes_in = len(data)
        self._upload_track = []

        t0 = time.perf_counter()
        # Absolute indexing makes the raw input the kernels' words
        # buffer, so its (async) upload starts here and overlaps
        # the whole host prepass below.
        words = input_words(data)
        self._early_words = self._put(words, lane=False)

        # Frame-pipelined path (single-device, non-instrumented): parse
        # ~1 MiB frame GROUPS and dispatch each group's kernels as soon
        # as it parses, so the prepass of group k overlaps the device
        # execution of groups < k — and each group ASSEMBLES (host C
        # executor + checksum) as soon as its fetches land, overlapping
        # the fetches of later groups.  measure_phases keeps the
        # one-plan path (its barrier semantics define the phase split),
        # as do mesh/multihost engines (their exchange collectives need
        # every process to enter identical phase order on one plan).
        out = bytearray()
        done = False
        prepass_s = 0.0
        asm_s = 0.0
        if (
            self.mesh is None
            and type(self)._run_both is DeviceEngine._run_both
            and not self.measure_phases
        ):
            snap = (stats.frames, stats.blocks, stats.fallback_frames)
            try:
                for g in self._iter_pipelined(data, words):
                    ta = time.perf_counter()
                    self._assemble_group(
                        *g,
                        out=out,
                        verify_checksum=verify_checksum,
                        include_skippable=include_skippable,
                    )
                    asm_s += time.perf_counter() - ta
                prepass_s = self._pipeline_parse_s
                done = True
            except Exception as e:
                _log.warning(
                    "pipelined kernel phase failed, replanning: %r", e
                )
                stats.fallback_reasons.append(f"pipelined: {e!r}")
                self._drain_fetches()
                out = bytearray()
                stats.frames, stats.blocks, stats.fallback_frames = snap
                stats.lit_lanes = stats.seq_lanes = 0
        if not done:
            tp = time.perf_counter()
            plan = build_batch_plan(
                data, max_window_size=self.max_window_size, words=words
            )
            prepass_s = time.perf_counter() - tp
            try:
                (lit_outs, lit_ok), (seq_outs, seq_ok) = self._run_both(plan)
            except Exception as e:  # last-resort: degrade to slow-but-correct
                # The module contract (see docstring) promises
                # bit-exactness by construction: an UNanticipated kernel
                # failure (not just an ok-flag trip) must route every
                # lane-bearing frame to the host oracle, never escape to
                # the caller.
                _log.warning(
                    "kernel phase failed, falling back to oracle: %r", e
                )
                stats.fallback_reasons.append(f"kernel phase: {e!r}")
                self._drain_fetches()
                lit_outs = [None] * plan.n_lit_lanes
                seq_outs = [None] * plan.n_seq_lanes
                lit_ok = np.zeros(plan.n_lit_lanes, dtype=bool)
                seq_ok = np.zeros(plan.n_seq_lanes, dtype=bool)
            ta = time.perf_counter()
            self._assemble_group(
                plan, lit_outs, lit_ok, seq_outs, seq_ok,
                out=out,
                verify_checksum=verify_checksum,
                include_skippable=include_skippable,
            )
            asm_s = time.perf_counter() - ta
        t3 = time.perf_counter()

        stats.bytes_out = len(out)
        # Pipelined runs overlap parse, device execution, fetch and
        # assembly, so ``prepass``/``assembly`` are accumulated
        # component times (informational) and ``kernels`` is the
        # residual of the overlapped span.
        stats.wall_s.update(
            prepass=prepass_s,
            kernels=(t3 - t0) - prepass_s - asm_s,
            assembly=asm_s,
            total=t3 - t0,
        )
        return bytes(out)

    def _assemble_group(
        self, plan, lit_outs, lit_ok, seq_outs, seq_ok, *,
        out: bytearray, verify_checksum: bool, include_skippable: bool,
    ) -> None:
        """Assemble one plan's frames (in order) onto ``out``."""
        stats = self.stats
        stats.lit_lanes += plan.n_lit_lanes
        stats.seq_lanes += plan.n_seq_lanes
        for fp in plan.frames:
            stats.frames += 1
            if isinstance(fp.frame, SkippableFrame):
                if include_skippable:
                    out += fp.frame.payload
                continue
            stats.blocks += len(fp.blocks)
            if fp.fallback or not _frame_lanes_ok(fp, lit_ok, seq_ok):
                stats.fallback_frames += 1
                out += decode_frame(fp.frame, verify_checksum=verify_checksum)
                continue
            try:
                frame_out = self._assemble_frame(fp, lit_outs, seq_outs)
                header = fp.frame.header
                if header.checksum_flag and verify_checksum:
                    computed = xxh64(frame_out) & 0xFFFFFFFF
                    if computed != fp.frame.checksum:
                        raise ChecksumMismatch(computed, fp.frame.checksum)
                if (
                    header.content_size is not None
                    and len(frame_out) != header.content_size
                ):
                    raise ImpossibleValue(
                        f"frame decoded {len(frame_out)}, "
                        f"header says {header.content_size}"
                    )
            except Exception as e:
                # Assembly/validation failed: re-decode the frame with
                # the oracle.  A kernel bug thereby degrades to correct
                # bytes; genuine corruption re-raises from the oracle as
                # the same typed error the host path would produce.
                _log.warning("frame assembly failed, oracle fallback: %r", e)
                stats.fallback_frames += 1
                stats.fallback_reasons.append(f"assembly: {e!r}")
                frame_out = decode_frame(
                    fp.frame, verify_checksum=verify_checksum
                )
            out += frame_out

    def _iter_pipelined(self, data, words):
        """Parse frame groups and dispatch each group's kernel calls as
        soon as it parses; one streaming fetch then covers every call
        in dispatch order, and groups are YIELDED as their fetches
        finish so the caller assembles group k while groups > k are
        still fetching.  Parse-only seconds accumulate in
        ``self._pipeline_parse_s``."""
        import time

        from ..format.frame import parse_frame
        from ..utils.bits import ForwardByteCursor

        self._pipeline_parse_s = 0.0
        staged = []
        cur = ForwardByteCursor(data)
        group_bytes = 1 << 20
        while not cur.is_empty:
            tp = time.perf_counter()
            frames = []
            start = cur.pos
            while not cur.is_empty and cur.pos - start < group_bytes:
                frames.append(
                    parse_frame(cur, max_window_size=self.max_window_size)
                )
            plan = build_batch_plan(
                data,
                max_window_size=self.max_window_size,
                words=words,
                frames=frames,
            )
            self._pipeline_parse_s += time.perf_counter() - tp
            lit_outs, lit_ok, lp = self._dispatch_literals(plan)
            seq_outs, seq_ok, sp = self._dispatch_sequences(plan)
            staged.append((plan, lit_outs, lit_ok, seq_outs, seq_ok, lp, sp))
        it = self._fetch_stream(
            [h for g in staged for h in _handles(g[5]) + _handles(g[6])]
        )
        for plan, lit_outs, lit_ok, seq_outs, seq_ok, lp, sp in staged:
            self._finish_literals(plan, lp, lit_outs, lit_ok, it)
            self._finish_sequences(plan, sp, seq_outs, seq_ok, it)
            self._retry_sequences(plan, seq_outs, seq_ok)
            yield plan, lit_outs, lit_ok, seq_outs, seq_ok

    def decompress(self, data, **kw) -> bytes:
        return self.decompress_with_stats(data, **kw)


def _handles(pending: list[tuple]) -> list:
    """Collect pending calls' device handles for one batched fetch.

    Each dense kernel call returns ONE packed array (entropy2.py), so
    each pending entry contributes exactly one handle."""
    return [hs for _idx, _cum, hs in pending]


def _pad_pow2(idx: np.ndarray, lo: int = 32) -> np.ndarray:
    """Lane ``rows`` of one kernel call: ``idx`` padded to the next
    power of two (>= ``lo``) with -1 rows.  Kernels read padding rows
    as lane 0 with zero work (``np.maximum(rows, 0)``); the finish
    steps skip them.  Pow2 lane counts keep the jit shape family small
    and stay divisible by pow2 device meshes."""
    idx = np.asarray(idx, dtype=np.int64)
    pad = _next_pow2(len(idx), lo=lo) - len(idx)
    return np.concatenate([idx, np.full(pad, -1, dtype=np.int64)])


def _subset_need(need: np.ndarray, subset) -> np.ndarray:
    """Per-lane work with lanes outside ``subset`` (if given) zeroed."""
    if subset is None:
        return need
    mask = np.zeros(len(need), dtype=bool)
    mask[subset] = True
    return np.where(mask, need, 0)


def _kernel_lanes(need: np.ndarray, block: int):
    """Lane layout of one Triton call (kernels/triton_decode.py).

    Lanes with work, sorted by DESCENDING need so each ``block``-lane
    program holds lanes that finish together, padded to a pow2 count
    (>= ``block``) of rows (``_pad_pow2``).  Returns (rows, blk_steps):
    ``blk_steps`` int32[len(rows) // block] is each block's largest
    need (padding rows count zero).  No lane with work -> empty rows."""
    need = np.asarray(need)
    live = np.flatnonzero(need > 0)
    if not len(live):
        return live, np.zeros(0, np.int32)
    rows = _pad_pow2(live[np.argsort(-need[live], kind="stable")], lo=block)
    work = np.where(rows >= 0, need[np.maximum(rows, 0)], 0)
    blk_steps = work.reshape(-1, block).max(axis=1).astype(np.int32)
    return rows, blk_steps


def _tier_split(need: np.ndarray, lo: int, max_calls: int = 2):
    """Group lanes into at most ``max_calls`` pow2-step calls.

    Returns [(lane_indices, pow2_steps)]; zero-need lanes are dropped.
    Steps are a per-CALL constant, so lanes are bucketed by pow2 step
    need and adjacent buckets are merged cheapest-padding-first until
    the call budget is met.  The budget was set against a slow remote
    link's per-call cost and is not measured on a GPU yet; only the
    scan form (CPU, mesh) uses it.
    """
    need = np.asarray(need)
    live = np.flatnonzero(need > 0)
    if len(live) == 0:
        return []
    buckets: dict[int, list[int]] = {}
    for lane in live:
        k = _next_pow2(int(need[lane]), lo=lo)
        buckets.setdefault(k, []).append(int(lane))
    ks = sorted(buckets)
    while len(ks) > max_calls:
        waste = [len(buckets[ks[i]]) * (ks[i + 1] - ks[i]) for i in range(len(ks) - 1)]
        i = int(np.argmin(waste))
        buckets[ks[i + 1]] += buckets.pop(ks[i])
        ks.pop(i)
    return [(np.asarray(sorted(buckets[k]), dtype=np.int64), k) for k in ks]


def _frame_lanes_ok(fp: FramePlan, lit_ok: np.ndarray, seq_ok: np.ndarray) -> bool:
    for bp in fp.blocks:
        for ref in bp.lit_streams:
            if not lit_ok[ref.lane]:
                return False
        if bp.seq_lane >= 0 and not seq_ok[bp.seq_lane]:
            return False
    return True
