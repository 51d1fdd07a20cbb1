"""Seconds from the process's start to the window's: imports, the CUDA
context, the kernels' build (first run of a checkout only), S0, the
graphs' capture and the warm-up of every call shape."""


def read(rec, variant):
    return rec.setup_s
