"""CRC32 (poly 0xEDB88320) integrity checks, copied from
nlzm_tpu/utils/crc32.py (the host function; the slicing tables there feed
a TPU kernel the port does not use).

zlib has the reference's polynomial, init and final xor (NLZM.cpp:126-210).
"""

import zlib


def crc32(data, prev: int = 0) -> int:
    """CRC32 of bytes-like `data`, chained from `prev`."""
    return zlib.crc32(bytes(data), prev) & 0xFFFFFFFF
