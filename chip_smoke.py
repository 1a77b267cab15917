#!/usr/bin/env python3
"""Smoke run of the batched decode engine on NVIDIA GPUs.

Drives the system's main path once through the entry points a user
calls, at the benchmark's real size, on one card:

1. environment: JAX version and device, the card's name and power
   limit, the native C runtime (required: without it assembly drops to
   the Python executor);
2. the ``gpu``-marked tests, in this process;
3. kernel check: each Triton kernel at the corpus's real lane counts,
   every lane compared byte for byte with the lax.scan form on the same
   plan, with ``compiled.memory_analysis()`` printed;
4. main path: ``DeviceEngine().decompress`` on a seeded 24 MB
   Silesia-like batch (4 MiB level-3 frames) and an 8 MiB level-19
   frame, against the payload, libzstd and the host oracle, with zero
   fallback frames;
5. the CLI (``python -m zstd_tpu.cli --device``), once with a trace;
6. ``DeviceEngine(device_execute=True)`` on one 4 MiB frame.

``--cards 4`` runs only the sharded path: ``ShardedEngine`` over four
cards on the same batch, compared with the payload and the one-card
engine.  ``--compare`` adds end-to-end and per-phase timings of the
Triton kernels against the lax.scan form (A B B A).

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform", "kind", "count"}}``; any failed
phase exits non-zero before it.  Usage:

    python chip_smoke.py [--cards 4] [--compare] [--mb MB] [--out DIR]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))


class SmokeFailure(Exception):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_info() -> list[str]:
    """One ``name, power.limit`` line per card, as nvidia-smi prints it."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        raise SmokeFailure(f"nvidia-smi failed: {e}") from None
    lines = [ln.strip() for ln in res.stdout.splitlines() if ln.strip()]
    check(res.returncode == 0 and lines, f"nvidia-smi failed: {res.stderr.strip()}")
    return lines


def timed(fn, *a, **kw):
    t0 = time.perf_counter()
    out = fn(*a, **kw)
    return out, time.perf_counter() - t0


# -- phases -----------------------------------------------------------------


def phase_environment(n_cards: int):
    import jax

    from zstd_tpu import native

    devs = jax.devices()
    log(f"jax {jax.__version__}; python {sys.version.split()[0]}")
    log(
        f"devices: platform={devs[0].platform} kind={devs[0].device_kind} "
        f"count={len(devs)}"
    )
    check(devs[0].platform == "gpu", f"no GPU: JAX's first device is {devs[0].platform}")
    check(len(devs) >= n_cards, f"need {n_cards} cards, JAX sees {len(devs)}")
    cards = card_info()
    for i, line in enumerate(cards):
        log(f"card {i}: {line}")
    log(f"native C runtime loaded: {native.available()}")
    check(native.available(), "native C runtime did not load")
    return devs, cards


def phase_gpu_tests() -> None:
    import pytest

    rc = pytest.main(
        [str(REPO / "tests"), "-q", "-m", "gpu", "-p", "no:cacheprovider",
         "-p", "no:randomly"]
    )
    check(rc == 0, f"gpu-marked tests failed (pytest exit code {int(rc)})")
    log("gpu-marked tests: passed")


def build_inputs(mb: float):
    from zstd_tpu.testing import libzstd
    from zstd_tpu.testing.corpus import build_corpus, compress_frames

    raw, t_build = timed(build_corpus, mb)
    (comp, compressor), t_comp = timed(compress_frames, raw, 3)
    hl_raw = raw[: 8 << 20]
    (hl_comp, _), _ = timed(compress_frames, hl_raw, 19, frame_bytes=len(hl_raw))
    log(f"compressor: {compressor} (libzstd loads: {libzstd.available()})")
    log(
        f"corpus: {len(raw)} B -> {len(comp)} B in 4 MiB level-3 frames "
        f"(built {t_build:.1f} s, compressed {t_comp:.1f} s); level-19 frame "
        f"{len(hl_raw)} B -> {len(hl_comp)} B"
    )
    return raw, comp, hl_raw, hl_comp


def _capture(monkey: dict, module, name: str, calls: list):
    orig = getattr(module, name)
    monkey[(module, name)] = orig

    def spy(*a, **kw):
        calls.append((orig, a, kw))
        return orig(*a, **kw)

    setattr(module, name, spy)


def _restore(monkey: dict) -> None:
    for (module, name), orig in monkey.items():
        setattr(module, name, orig)


def run_plan(route: str, plan):
    """``_run_both`` on ``plan`` with the given kernel family; returns
    (outputs, captured kernel calls by phase)."""
    from zstd_tpu.kernels import entropy2, triton_decode
    from zstd_tpu.runtime.engine import DeviceEngine

    calls = {"literals": [], "sequences": []}
    monkey: dict = {}
    mod = triton_decode if route == "kernel" else entropy2
    names = (
        ("decode_literals_gpu", "decode_sequences_gpu")
        if route == "kernel"
        else ("decode_literals_dense", "decode_sequences_dense")
    )
    _capture(monkey, mod, names[0], calls["literals"])
    _capture(monkey, mod, names[1], calls["sequences"])
    try:
        eng = DeviceEngine()
        eng._route_pin = route
        res = eng._run_both(plan)
    finally:
        _restore(monkey)
    return res, calls


def phase_time(calls, reps: int = 5) -> float:
    """Median seconds to replay one phase's captured kernel calls."""
    import jax

    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready([fn(*a, **kw) for fn, a, kw in calls])
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2]


def phase_kernel_check(comp: bytes, compare: bool) -> None:
    import numpy as np

    from zstd_tpu.format.block_table import build_batch_plan

    plan = build_batch_plan(comp)
    log(f"plan: {plan.n_lit_lanes} literal lanes, {plan.n_seq_lanes} sequence lanes")
    (k_res, k_calls), t_k = timed(run_plan, "kernel", plan)
    (s_res, s_calls), t_s = timed(run_plan, "scan", plan)
    log(f"first call incl. compile: kernels {t_k:.2f} s, scan form {t_s:.2f} s")
    (lo_k, ok_lk), (so_k, ok_sk) = k_res
    (lo_s, ok_ls), (so_s, ok_ss) = s_res
    check(ok_lk.all() and ok_sk.all(), "kernel flagged a lane of valid input")
    check(np.array_equal(ok_ls, ok_lk) and np.array_equal(ok_ss, ok_sk), "ok flags differ")
    for lane, (a, b) in enumerate(zip(lo_k, lo_s)):
        check(np.array_equal(a, b), f"literal lane {lane} differs from the scan form")
    for lane, (a, b) in enumerate(zip(so_k, so_s)):
        for k in range(3):
            check(np.array_equal(a[k], b[k]), f"sequence lane {lane} field {k} differs")
    log(
        f"kernel check: {plan.n_lit_lanes} literal and {plan.n_seq_lanes} "
        "sequence lanes byte-identical to the lax.scan form"
    )
    for phase in ("literals", "sequences"):
        for fn, a, kw in k_calls[phase]:
            mem = fn.lower(*a, **kw).compile().memory_analysis()
            log(f"memory_analysis {phase} kernel: {mem}")
    if compare:
        for phase in ("literals", "sequences"):
            tk = phase_time(k_calls[phase])
            ts = phase_time(s_calls[phase])
            log(
                f"phase {phase}: kernel {tk * 1e3:.3f} ms ({len(k_calls[phase])} "
                f"call), scan form {ts * 1e3:.3f} ms ({len(s_calls[phase])} calls)"
            )


def decode_checked(engine, data: bytes, expect: bytes, what: str):
    out, dt = timed(engine.decompress, data)
    st = engine.stats
    check(out == expect, f"{what}: output differs from the payload")
    if st.fallback_reasons:
        log(f"{what}: fallback_reasons {st.fallback_reasons}")
    check(st.fallback_frames == 0, f"{what}: {st.fallback_frames} fallback frames")
    check(not st.fallback_reasons, f"{what}: fallback reasons {st.fallback_reasons}")
    check(st.kernel_calls > 0, f"{what}: no kernel calls")
    return dt


def phase_main_path(raw, comp, hl_raw, hl_comp, card: str, compare: bool) -> None:
    from zstd_tpu.runtime.engine import DeviceEngine
    from zstd_tpu.runtime.oracle import decompress as oracle_decompress
    from zstd_tpu.testing import libzstd

    if libzstd.available():
        check(libzstd.decompress(comp) == raw, "libzstd disagrees with the payload")
        check(libzstd.decompress(hl_comp) == hl_raw, "libzstd disagrees (level 19)")
    eng = DeviceEngine()
    for name, data, expect in (("batch", comp, raw), ("level-19", hl_comp, hl_raw)):
        first = decode_checked(eng, data, expect, name)
        warm = sorted(decode_checked(eng, data, expect, name) for _ in range(3))[1]
        st = eng.stats
        log(
            f"main path {name}: bit-exact, fallback_frames=0, "
            f"kernel_calls={st.kernel_calls}, lit_lanes={st.lit_lanes}, "
            f"seq_lanes={st.seq_lanes}; first call {first:.2f} s, warm "
            f"{warm:.4f} s = {len(expect) / warm / 1e9:.4f} GB/s "
            f"(informational; card {card})"
        )
    # One 4 MiB frame against the host oracle.
    frame0 = first_frame(comp)
    check(eng.decompress(frame0) == oracle_decompress(frame0), "engine vs oracle differ")
    log("main path: first 4 MiB frame equals the host oracle's output")
    if compare:
        compare_routes(comp, raw, hl_comp, hl_raw, card)


def first_frame(comp: bytes) -> bytes:
    from zstd_tpu.format.frame import parse_frame
    from zstd_tpu.utils.bits import ForwardByteCursor

    cur = ForwardByteCursor(comp)
    parse_frame(cur)
    return comp[: cur.pos]


def compare_routes(comp, raw, hl_comp, hl_raw, card: str) -> None:
    """End-to-end engine time with the Triton kernels (A) against the
    lax.scan form (B), in turns A B B A after a warm-up of each."""
    from zstd_tpu.runtime.engine import DeviceEngine

    engines = {}
    for route in ("kernel", "scan"):
        eng = DeviceEngine()
        eng._route_pin = route
        engines[route] = eng
    for name, data, expect in (("batch", comp, raw), ("level-19", hl_comp, hl_raw)):
        for eng in engines.values():
            decode_checked(eng, data, expect, name)
        ts = {"kernel": [], "scan": []}
        for route in ("kernel", "scan", "scan", "kernel"):
            ts[route].append(decode_checked(engines[route], data, expect, name))
        log(
            f"A/B {name} end to end: kernels {ts['kernel']} s, scan form "
            f"{ts['scan']} s (card {card})"
        )


def phase_cli(raw, comp, hl_raw, hl_comp, out_dir: pathlib.Path) -> None:
    from zstd_tpu import cli

    out_dir.mkdir(parents=True, exist_ok=True)
    for name, data, expect in (("batch", comp, raw), ("level19", hl_comp, hl_raw)):
        src, dst = out_dir / f"{name}.zst", out_dir / f"{name}.out"
        src.write_bytes(data)
        rc = cli.main([str(src), "--device", "-o", str(dst)])
        check(rc == 0 and dst.read_bytes() == expect, f"CLI --device {name} failed")
        dst.unlink()
        log(f"cli --device {name}: bit-exact")
    trace = out_dir / "trace"
    shutil.rmtree(trace, ignore_errors=True)
    src, dst = out_dir / "level19.zst", out_dir / "level19.out"
    rc = cli.main([str(src), "--device", "-o", str(dst), "--trace-dir", str(trace)])
    check(rc == 0 and dst.read_bytes() == hl_raw, "CLI --trace-dir failed")
    xplanes = list(trace.rglob("*.xplane.pb"))
    check(xplanes, "trace directory holds no .xplane.pb")
    log(f"cli --trace-dir: bit-exact, trace {xplanes[0].relative_to(out_dir)}")
    for f in out_dir.glob("*.zst"):
        f.unlink()
    dst.unlink()


def phase_device_execute(raw, comp) -> None:
    from zstd_tpu.runtime.engine import DeviceEngine

    eng = DeviceEngine(device_execute=True)
    out, dt = timed(eng.decompress, first_frame(comp))
    check(out == raw[: 4 << 20], "device_execute output differs")
    log(f"device_execute: first 4 MiB frame bit-exact ({dt:.2f} s incl. compile)")


def phase_sharded(raw, comp, n_cards: int) -> None:
    """ShardedEngine over ``n_cards`` cards against the payload and the
    one-card engine, with each card's share of the lanes."""
    import numpy as np

    from zstd_tpu.parallel.dist import ShardedEngine
    from zstd_tpu.parallel.mesh import make_mesh
    from zstd_tpu.runtime.engine import DeviceEngine

    one = DeviceEngine().decompress(comp)
    check(one == raw, "one-card engine output differs from the payload")
    mesh = make_mesh(n_cards)
    eng = ShardedEngine(mesh)
    share = {"real": np.zeros(n_cards, np.int64), "slots": np.zeros(n_cards, np.int64)}
    devices_seen: set = set()
    orig_pad, orig_put = eng._pad_lanes, eng._put

    def pad_spy(idx):
        rows = orig_pad(idx)
        blocks = rows.reshape(n_cards, -1)
        share["real"] += (blocks >= 0).sum(axis=1)
        share["slots"] += blocks.shape[1]
        return rows

    def put_spy(a, *, lane):
        x = orig_put(a, lane=lane)
        if lane:
            shards = x.addressable_shards
            devices_seen.update(s.device.id for s in shards)
            rows = {s.data.shape[0] for s in shards}
            check(len(shards) == n_cards and len(rows) == 1, f"lane array not split evenly: {rows}")
        return x

    eng._pad_lanes, eng._put = pad_spy, put_spy
    out, first = timed(eng.decompress, comp)
    check(out == raw, "sharded output differs from the payload")
    check(out == one, "sharded output differs from the one-card engine")
    st = eng.stats
    check(st.fallback_frames == 0 and not st.fallback_reasons, f"sharded fallbacks {st.fallback_reasons}")
    check(len(devices_seen) == n_cards, f"lane arrays on devices {sorted(devices_seen)}")
    eng._pad_lanes, eng._put = orig_pad, orig_put
    warm = sorted(timed(eng.decompress, comp)[1] for _ in range(3))[1]
    log(
        f"sharded ({n_cards} cards, lax.scan form under GSPMD): bit-exact vs payload "
        f"and the one-card engine, fallback_frames=0, kernel_calls={st.kernel_calls}"
    )
    for d in range(n_cards):
        log(
            f"card {d}: {int(share['real'][d])} real lanes of "
            f"{int(share['slots'][d])} lane slots"
        )
    log(f"sharded first call {first:.2f} s, warm {warm:.4f} s (informational)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4))
    ap.add_argument("--compare", action="store_true",
                    help="also time the Triton kernels against the lax.scan form")
    ap.add_argument("--mb", type=float, default=24.0,
                    help="corpus size in MB (default 24, the benchmark's batch)")
    ap.add_argument("--out", default=str(REPO / "chiprun_out" / "smoke"),
                    help="directory for the CLI phase's files and trace")
    args = ap.parse_args(argv)
    try:
        import zstd_tpu  # noqa: F401
    except ImportError as e:
        log(f"FAIL: the zstd_tpu package is not beside this script: {e}")
        return 1
    try:
        devs, cards = phase_environment(args.cards)
        card = cards[0]
        if args.cards > 1:
            raw, comp, _, _ = build_inputs(args.mb)
            phase_sharded(raw, comp, args.cards)
        else:
            phase_gpu_tests()
            raw, comp, hl_raw, hl_comp = build_inputs(args.mb)
            phase_kernel_check(comp, args.compare)
            phase_main_path(raw, comp, hl_raw, hl_comp, card, args.compare)
            phase_cli(raw, comp, hl_raw, hl_comp, pathlib.Path(args.out))
            phase_device_execute(raw, comp)
    except SmokeFailure as e:
        log(f"FAIL: {e}")
        return 1
    dev = devs[0]
    log(f"card: {card}")
    print(json.dumps({
        "ok": True,
        "device": {"platform": dev.platform, "kind": dev.device_kind, "count": len(devs)},
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
