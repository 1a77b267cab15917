#!/usr/bin/env python3
"""Per-phase device-compute profile of the batch decode (r3 tooling).

Times, with block_until_ready between stages: plan upload, the literals
kernel calls, the sequences kernel calls, and the batched fetch — each
separately — so 'device_compute' stops being one opaque number.
Usage: python tools/phase_profile.py [corpus_MB]
"""

from __future__ import annotations

import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402


def main() -> None:
    import jax

    from zstd_tpu.testing.corpus import build_corpus
    from zstd_tpu.format.block_table import build_batch_plan
    from zstd_tpu.runtime.engine import DeviceEngine, _handles
    from zstd_tpu.runtime.jaxcache import enable_compilation_cache
    from zstd_tpu.testing import libzstd

    enable_compilation_cache()
    mb = float(sys.argv[1]) if len(sys.argv) > 1 else 24.0
    raw = build_corpus(mb)
    chunk = 4 << 20
    comp = b"".join(
        libzstd.compress(raw[i : i + chunk], 3, checksum=True)
        for i in range(0, len(raw), chunk)
    )
    eng = DeviceEngine()
    # Warm-up: compile every shape.
    assert eng.decompress(comp) == raw

    res: dict = {"corpus_MB": mb, "device": str(jax.devices()[0])}
    plan = build_batch_plan(comp)

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        jax.block_until_ready(out)
        res[name] = round(time.perf_counter() - t0, 4)
        return out

    eng.stats.upload_bytes = 0
    eng._dev_cache = None
    timed("upload_plan_s", lambda: list(eng._plan_dev(plan).values()))
    res["upload_plan_MB"] = round(eng.stats.upload_bytes / 1e6, 2)

    eng.stats.upload_bytes = 0
    lp = timed("lit_dispatch_compute_s", lambda: eng._dispatch_literals(plan)[2])
    res["lit_upload_MB"] = round(eng.stats.upload_bytes / 1e6, 2)
    eng.stats.upload_bytes = 0
    sp = timed("seq_dispatch_compute_s", lambda: eng._dispatch_sequences(plan)[2])
    res["seq_upload_MB"] = round(eng.stats.upload_bytes / 1e6, 2)

    handles = _handles(lp) + _handles(sp)
    t0 = time.perf_counter()
    fetched = [np.asarray(a) for a in jax.device_get(handles)]
    res["fetch_s"] = round(time.perf_counter() - t0, 4)
    res["fetch_MB"] = round(sum(a.nbytes for a in fetched) / 1e6, 2)

    res["lit_call_lanes"] = [len(c) - 1 for _i, c, _h in lp]
    res["seq_call_lanes"] = [len(c) - 1 for _i, c, _h in sp]
    print(json.dumps(res))


if __name__ == "__main__":
    main()
