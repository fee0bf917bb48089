"""Format constants the port reads, copied from nlzm_tpu/constants.py
(SENTINEL_FRAME from nlzm_tpu/format/frame.py).

The wire format is defined there; tests/test_torch_host.py pins every
value here to it.
"""

# ---- adaptive CDF scaling (NLZM.cpp:212-217) ----
CDF_ADAPT_BITS = 7
CDF_SCALE_BITS = 14
CDF_SCALE_TOTAL = 1 << CDF_SCALE_BITS

# ---- match finder: 4-byte multiplicative hash (device parse) ----
HASH4_MULT = 987660757

# ---- parser (NLZM.cpp:1458) ----
PARSE_TABLE_SIZE = 1 << 12

# ---- single-stream file (NLZM.cpp:1722-1725, 1913-1921) ----
FILE_HEADER_BYTES = 4
# The reference encoder shrinks the window down to 10 bits for tiny inputs
# (NLZM.cpp:1716); the whole encodable range decodes.
MIN_HIST_BITS_DECODE = 10
MAX_HIST_BITS = 28
MIN_FRAME_BITS = 12
MAX_FRAME_BITS = 20
DEFAULT_HIST_BITS = 22
SENTINEL_FRAME = b"\x00\x00\x00\x00"  # a zero frame header ends the stream


def frame_bits_for(hist_bits: int) -> int:
    """Frame size (bits) derived from window bits (NLZM.cpp:1722)."""
    return max(14, min(17, hist_bits - 2))


def chunk_size_for(frame_bits: int) -> int:
    """Input bytes consumed per frame (NLZM.cpp:1724)."""
    frame_size = 1 << frame_bits
    return (frame_size * 15) // 16 - 0x200


def shrink_hist_bits(hist_bits: int, file_len: int) -> int:
    """Auto-shrink window for small inputs (NLZM.cpp:1716-1718)."""
    while hist_bits > 10 and file_len < (1 << (hist_bits - 1)):
        hist_bits -= 1
    return hist_bits
