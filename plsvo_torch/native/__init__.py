"""Native host code of the port, built on demand with g++ into
`build/plsvo_torch_native/` at the root of the checkout.

`loader`: image decoding (PGM/PPM, 8-bit PNG, BMP) and a threaded
prefetcher, a copy of the JAX package's native loader, bound with ctypes.
Nothing builds at import.
"""
