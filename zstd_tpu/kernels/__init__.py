"""Device decode kernels.

* ``triton_decode.py`` — Pallas-Triton kernels for NVIDIA GPUs: one
  launch per phase, each lane running its whole Huffman-literals or
  interleaved-tANS sequences loop with per-lane indexed loads (the
  engine's GPU path)
* ``entropy2.py``    — lax.scan kernel family (plain XLA on any
  backend: the CPU path, the mesh/GSPMD path, the wide retry, and the
  reference the Triton kernels are tested against)
* ``bitbuf.py``      — per-lane N-word buffered bit windows (the scan
  kernels' building block)
* ``lz77_device.py`` — pointer-doubling sequence execution (optional;
  the host C executor is the default)
"""
