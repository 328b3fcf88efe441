"""Bit-exact NumPy reference implementation ("the oracle").

Reproduces the reference binary's per-read behavior — including
tie-breaking, traversal order, stale-buffer and out-of-bounds-read
quirks — so the device pipeline can be validated byte-for-byte against
it and it against the reference binary.
"""
