#!/usr/bin/env python3
"""Benchmark: batch ZSTD decode throughput on one GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "GB/s", "vs_baseline": N, ...}

The corpus is Silesia-like and seed-generated
(``zstd_tpu.testing.corpus``): natural-language-like text, structured
records, low-entropy noise and repetitive binary, compressed with
libzstd at level 3 with checksums — multi-frame, multi-block,
exercising huffman/FSE/treeless/repeat paths.  It is the same corpus
``chip_smoke.py`` decodes.

``vs_baseline``: the recorded baseline is this repo's own serial host
oracle measured on a slice of the same corpus.  The script refuses to
run unless JAX's first device is a GPU.
"""

from __future__ import annotations

import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

import numpy as np  # noqa: E402


def card_info() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi prints it."""
    import subprocess

    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return res.stdout.strip().splitlines()[0] if res.stdout.strip() else res.stderr.strip()


def main() -> None:
    import jax

    from zstd_tpu.runtime.engine import DeviceEngine
    from zstd_tpu.runtime.oracle import decompress as oracle_decompress
    from zstd_tpu.testing import libzstd
    from zstd_tpu.testing.corpus import build_corpus, compress_frames

    dev0 = jax.devices()[0]
    if dev0.platform != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX's first device is {dev0.platform}")

    raw = build_corpus()
    # One frame per 4 MiB chunk (stock 128 KiB blocks) — the standard
    # batch-decode workload.
    comp, _compressor = compress_frames(raw, 3)

    engine = DeviceEngine()
    # Warm-up: compile all bucket shapes and validate bit-exactness.
    out = engine.decompress(comp)
    assert out == raw, "bench decode is not bit-exact"

    # Median of 5, with best/worst in detail for the spread.
    iters = 5
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        engine.decompress(comp)
        times.append(time.perf_counter() - t0)
    times.sort()
    dt = times[len(times) // 2]

    gbs = len(raw) / dt / 1e9

    # --- transfer-accounted phase split --------------------------------
    # One instrumented pass: a block_until_ready barrier between
    # dispatch and fetch splits kernel wall time into
    # dispatch (host issue + uploads) / device compute / fetch, and the
    # engine counts bytes moved each way.
    engine.measure_phases = True
    engine.decompress(comp)  # measure-mode warm-up: the classic (non-
    # pipelined) path this mode uses has its own plan shapes to compile
    engine.decompress(comp)
    engine.measure_phases = False
    ph = engine.stats.as_dict()
    upload_mb = ph["upload_bytes"] / 1e6
    fetch_mb = ph["fetch_bytes"] / 1e6
    w = ph["wall_s"]
    # Host-to-device and device-to-host bandwidth probes (32 MB buffer,
    # one round each way).
    buf = np.random.default_rng(1).integers(0, 255, 32 << 20, dtype=np.uint8)
    t0 = time.perf_counter()
    dev_buf = jax.device_put(buf)
    jax.block_until_ready(dev_buf)
    up_gbs = buf.nbytes / (time.perf_counter() - t0) / 1e9
    t0 = time.perf_counter()
    _ = np.asarray(dev_buf)
    down_gbs = buf.nbytes / (time.perf_counter() - t0) / 1e9
    del buf, dev_buf

    # compute_only excludes the H2D upload tail (measured separately as
    # upload_wait by blocking on the input arrays before the kernel
    # outputs); compute_incl_upload includes it.
    compute_s = w.get("dispatch", 0.0) + w.get("device_compute", 0.0)
    compute_up_s = compute_s + w.get("upload_wait", 0.0)
    transfer_detail = {
        "kernel_s": {
            k: round(w[k], 4)
            for k in ("dispatch", "upload_wait", "device_compute", "fetch")
            if k in w
        },
        "upload_MB": round(upload_mb, 2),
        "fetch_MB": round(fetch_mb, 2),
        "h2d_GBs": round(up_gbs, 4),
        "d2h_GBs": round(down_gbs, 4),
        "fetch_GBs": round(
            fetch_mb / 1e3 / w["fetch"], 4
        ) if w.get("fetch") else None,
        "compute_only_GBs": round(len(raw) / compute_s / 1e9, 4) if compute_s else None,
        "compute_incl_upload_GBs": round(len(raw) / compute_up_s / 1e9, 4)
        if compute_up_s
        else None,
    }

    main_stats = engine.stats.as_dict()  # before hl-mix reuses the engine

    # --- high-level stream mix -----------------------------------------
    # Level-19 frames carry treeless/repeat table chains and long
    # offsets (8 MiB windows); their kernel-path perf was previously
    # only correctness-tested.  Bit-exactness-gated like the main run.
    hl_raw = raw[: 8 << 20]
    hl_comp = libzstd.compress(hl_raw, 19, checksum=True)
    hl_out = engine.decompress(hl_comp)
    assert hl_out == hl_raw, "high-level mix decode is not bit-exact"
    t0 = time.perf_counter()
    for _ in range(2):
        engine.decompress(hl_comp)
    hl_gbs = len(hl_raw) / ((time.perf_counter() - t0) / 2) / 1e9
    hl_detail = {
        "corpus_bytes": len(hl_raw),
        "compressed_bytes": len(hl_comp),
        "gbs": round(hl_gbs, 4),
        "fallback_frames": engine.stats.fallback_frames,
    }

    # --- encoder ratio table ------------------------------------------
    # ours vs libzstd at matched levels on the corpus's four content
    # types; values are ours_bytes / libzstd_bytes (< 1 = we're smaller).
    from zstd_tpu import encode as zt_encode

    text = raw[:200_000]
    rng2 = np.random.default_rng(7)
    enc_sets = {
        "text": text,
        "records": b"".join(
            b"id=%08d|name=user%04d|score=%05d;" % (i, i % 7919, (i * 2654435761) % 99999)
            for i in range(6000)
        ),
        "lowent": rng2.choice(
            np.frombuffer(b"ACGT", dtype=np.uint8), 200_000
        ).tobytes(),
        "repetitive": (lambda b: b"".join(
            b[: int(k)] for k in rng2.integers(512, 4096, 80)
        ))(rng2.integers(0, 256, 4096, dtype=np.uint8).tobytes()),
    }
    encode_ratios: dict = {}
    for name, payload in enc_sets.items():
        encode_ratios[name] = {}
        for lv in (1, 3, 6, 19):
            z = len(libzstd.compress(payload, lv))
            c = zt_encode.compress(payload, level=lv)
            assert libzstd.decompress(c) == payload, (name, lv)
            encode_ratios[name][f"L{lv}"] = round(len(c) / z, 3)

    # Baseline: serial host oracle on a slice, extrapolated.
    slice_comp = libzstd.compress(raw[: 2 << 20], 3, checksum=True)
    t0 = time.perf_counter()
    oracle_out = oracle_decompress(slice_comp)
    oracle_dt = time.perf_counter() - t0
    oracle_gbs = len(oracle_out) / oracle_dt / 1e9

    # Hard bar: libzstd itself, single-threaded, on this host.
    t0 = time.perf_counter()
    for _ in range(iters):
        libzstd.decompress(comp)
    libzstd_gbs = len(raw) / ((time.perf_counter() - t0) / iters) / 1e9

    stats = main_stats
    report = {
        "metric": "silesia-like batch decode throughput (1 GPU, bit-exact)",
        "value": round(gbs, 4),
        "unit": "GB/s",
        "vs_baseline": round(gbs / oracle_gbs, 2),
        "detail": {
            "device": {
                "platform": dev0.platform,
                "kind": dev0.device_kind,
                "count": len(jax.devices()),
            },
            "card": card_info(),
            "corpus_bytes": len(raw),
            "compressed_bytes": len(comp),
            "iters": iters,
            "best_gbs": round(len(raw) / times[0] / 1e9, 4),
            "worst_gbs": round(len(raw) / times[-1] / 1e9, 4),
            "oracle_baseline_gbs": round(oracle_gbs, 4),
            "libzstd_serial_gbs": round(libzstd_gbs, 4),
            "vs_libzstd_serial": round(gbs / libzstd_gbs, 4),
            "lit_lanes": stats["lit_lanes"],
            "seq_lanes": stats["seq_lanes"],
            "kernel_calls": stats["kernel_calls"],
            "fallback_frames": stats["fallback_frames"],
            "wall_s": {k: round(v, 3) for k, v in stats["wall_s"].items()},
            "transfers": transfer_detail,
            "highlevel_mix": hl_detail,
            "encode_vs_libzstd": encode_ratios,
        },
    }
    print(json.dumps(report))


if __name__ == "__main__":
    main()
