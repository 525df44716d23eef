"""Utilities: image I/O (stb-parity gray+alpha loading, 1-channel writers)
and timing and tracing."""
