"""Native (C++) host library: grid-hashed clustering and the 2D BPA
boundary walk, a copy of ``tisph_tpu.native``.

Built on first use with make and g++ into ``build/tisph_tpu_torch/native/``
beside the package and loaded with ctypes (``loader.py``).  Every caller
falls back to its numpy version when no compiler is available.  Host code:
it replaces no device kernel.
"""
