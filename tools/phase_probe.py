#!/usr/bin/env python3
"""Scratch probe: split the bench decode's device window into
upload / literals / sequences and the upload bytes by category."""

from __future__ import annotations

import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import numpy as np  # noqa: E402

from zstd_tpu.testing.corpus import build_corpus  # noqa: E402
from zstd_tpu.format.block_table import build_batch_plan  # noqa: E402
from zstd_tpu.runtime.engine import DeviceEngine, _handles  # noqa: E402
from zstd_tpu.testing import libzstd  # noqa: E402


def main() -> None:
    raw = build_corpus()
    chunk = 4 << 20
    comp = b"".join(
        libzstd.compress(raw[i : i + chunk], 3, checksum=True)
        for i in range(0, len(raw), chunk)
    )

    engine = DeviceEngine()
    out = engine.decompress(comp)  # warm-up compile
    assert out == raw

    t0 = time.perf_counter()
    plan = build_batch_plan(comp)
    t1 = time.perf_counter()
    print(f"prepass: {t1 - t0:.3f}s")

    # Upload categories.
    engine.stats.upload_bytes = 0
    engine._dev_cache = None
    dev = engine._plan_dev(plan)
    jax.block_until_ready(list(dev.values()))
    t2 = time.perf_counter()
    plan_up = engine.stats.upload_bytes
    print(f"plan residents upload: {plan_up/1e6:.2f} MB in {t2 - t1:.3f}s "
          f"({plan_up/1e9/(t2-t1):.3f} GB/s)")
    print(f"  words={plan.words.nbytes/1e6:.2f} MB  "
          f"fse=({len(plan.fse_off)} slots, {len(plan.fse_flat0)} rows x2)="
          f"{2*plan.fse_flat0.nbytes/1e6:.2f} MB  "
          f"huff(T={plan.huff_ranked.shape[0]})="
          f"{(plan.huff_limits.nbytes*4 + plan.huff_ranked.nbytes)/1e6:.2f} MB")

    # Literals only.
    engine.stats.upload_bytes = 0
    t0 = time.perf_counter()
    lit_outs, lit_ok, lp = engine._dispatch_literals(plan)
    t1 = time.perf_counter()
    jax.block_until_ready(_handles(lp))
    t2 = time.perf_counter()
    arrs = engine._fetch_tree(_handles(lp))
    t3 = time.perf_counter()
    lit_fetch = sum(a.nbytes for a in arrs)
    print(f"literals: dispatch {t1-t0:.3f}s (lane upload {engine.stats.upload_bytes/1e6:.2f} MB) "
          f"compute {t2-t1:.3f}s fetch {t3-t2:.3f}s ({lit_fetch/1e6:.2f} MB)")

    # Sequences only.
    engine.stats.upload_bytes = 0
    t0 = time.perf_counter()
    seq_outs, seq_ok, sp = engine._dispatch_sequences(plan)
    t1 = time.perf_counter()
    jax.block_until_ready(_handles(sp))
    t2 = time.perf_counter()
    arrs = engine._fetch_tree(_handles(sp))
    t3 = time.perf_counter()
    seq_fetch = sum(a.nbytes for a in arrs)
    print(f"sequences: dispatch {t1-t0:.3f}s (lane upload {engine.stats.upload_bytes/1e6:.2f} MB) "
          f"compute {t2-t1:.3f}s fetch {t3-t2:.3f}s ({seq_fetch/1e6:.2f} MB)")

    # Step counts per tier for context.
    from zstd_tpu.kernels.entropy2 import LIT_SYMS_PER_STEP, SEQ_SLOTS_PER_STEP
    from zstd_tpu.runtime.engine import _tier_split
    lit_tiers = _tier_split(-(-plan.lit_regen // LIT_SYMS_PER_STEP), lo=4)
    seq_tiers = _tier_split(-(-plan.seq_nseq // SEQ_SLOTS_PER_STEP), lo=2, max_calls=2)
    print("lit tiers:", [(len(i), s) for i, s in lit_tiers])
    print("seq tiers:", [(len(i), s) for i, s in seq_tiers])
    print(f"total lit syms={int(plan.lit_regen.sum())} total seqs={int(plan.seq_nseq.sum())}")


if __name__ == "__main__":
    main()
