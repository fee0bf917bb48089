"""Format constants the port reads, copied from nlzm_tpu/constants.py.

The wire format is defined there; tests/test_torch_host.py pins every
value here to it.
"""

# ---- adaptive CDF scaling (NLZM.cpp:212-217) ----
CDF_ADAPT_BITS = 7
CDF_SCALE_BITS = 14
CDF_SCALE_TOTAL = 1 << CDF_SCALE_BITS

# ---- match finder: 4-byte multiplicative hash (device parse) ----
HASH4_MULT = 987660757


def frame_bits_for(hist_bits: int) -> int:
    """Frame size (bits) derived from window bits (NLZM.cpp:1722)."""
    return max(14, min(17, hist_bits - 2))


def chunk_size_for(frame_bits: int) -> int:
    """Input bytes consumed per frame (NLZM.cpp:1724)."""
    frame_size = 1 << frame_bits
    return (frame_size * 15) // 16 - 0x200
