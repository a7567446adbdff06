"""Hand-written CUDA kernels for exact-Lp candidate scoring.

  csrc/          — gather_lp.cu and gather_lp_abandon.cu (sm_90a)
  _build.py      — builds them with nvcc at first use, loads them with ctypes
  lp_distance.py — their wrappers (CUDA -> kernel, CPU -> plain version),
                   with launch counts
  ref.py         — the plain PyTorch versions
  ops.py         — lp_gather_distance / lp_gather_abandon for the query path
"""
