"""Seeded Silesia-like corpus shared by the benchmark and the smoke run.

Every part is generated from a seed, so any machine decodes the same
bytes: natural-language-like text, structured records, low-entropy
noise and repetitive binary with long matches.
"""

from __future__ import annotations

import numpy as np

FRAME_BYTES = 4 << 20  # one frame per 4 MiB chunk (stock 128 KiB blocks)


def seeded_text(rng: np.random.Generator, n_bytes: int) -> bytes:
    """English-like text: a Zipf-weighted vocabulary of lowercase
    words, capitalised sentences and ~70-column lines."""
    vocab = [
        bytes(rng.integers(97, 123, int(n), dtype=np.uint8))
        for n in rng.integers(1, 12, 4096)
    ]
    p = 1.0 / np.arange(1, len(vocab) + 1)
    picks = rng.choice(len(vocab), n_bytes // 5, p=p / p.sum())
    ends = rng.random(len(picks)) < 0.08
    out, line = bytearray(), 0
    cap = True
    for w, end in zip(picks, ends):
        word = vocab[int(w)]
        if cap:
            word = word[:1].upper() + word[1:]
        word += b"." if end else b""
        cap = bool(end)
        if line + len(word) > 70:
            out += b"\n"
            line = 0
        elif line:
            out += b" "
            line += 1
        out += word
        line += len(word)
        if len(out) >= n_bytes:
            break
    return bytes(out[:n_bytes])


def build_corpus(target_mb: float = 24.0, seed: int = 0xC0DEC) -> bytes:
    """Deterministic Silesia-like mixed corpus (decompressed form)."""
    rng = np.random.default_rng(seed)
    parts = [seeded_text(rng, 1_200_000)]
    # Structured records (database-ish).
    parts.append(
        b"".join(
            b"id=%08d|name=user%04d|score=%05d;"
            % (i, i % 7919, (i * 2654435761) % 99999)
            for i in range(60_000)
        )
    )
    # Low-entropy noise (sampled small alphabet).
    parts.append(
        rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), 2_000_000).tobytes()
    )
    # Repetitive binary with long matches.
    block = rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
    parts.append(b"".join(block[: int(k)] for k in rng.integers(512, 4096, 2_000)))

    blob = b"".join(parts)
    reps = max(1, int(target_mb * 1e6) // len(blob))
    return (blob * (reps + 1))[: int(target_mb * 1e6)]


def compress_frames(raw: bytes, level: int = 3, frame_bytes: int = FRAME_BYTES):
    """``raw`` as concatenated checksummed frames of ``frame_bytes``
    each: (compressed bytes, compressor name).  Uses the system libzstd
    when it loads, else this package's encoder."""
    from . import libzstd

    if libzstd.available():
        comp, name = (lambda c: libzstd.compress(c, level, checksum=True)), "libzstd"
    else:
        from .. import encode

        comp, name = (lambda c: encode.compress(c, level, checksum=True)), "zstd_tpu.encode"
    frames = [comp(raw[i : i + frame_bytes]) for i in range(0, len(raw), frame_bytes)]
    return b"".join(frames), name
