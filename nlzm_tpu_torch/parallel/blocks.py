"""NLZP container decode on a PyTorch device.

Counterpart of the wide branch of nlzm_tpu/parallel/blocks.py::
decode_container. Container parsing, CRC verification and the host
encoder are nlzm_tpu's own jax-free host code, imported unchanged:
encode_container is re-exported as is (host encode is the only encode of
the port so far).
"""

from nlzm_tpu import native  # noqa: F401  (re-exported: the host encoder's library)
from nlzm_tpu.parallel.blocks import (  # noqa: F401  (re-exported)
    IntegrityError,
    _verified,
    block_payloads,
    encode_container,
    parse_container,
)

from ..ops.wide_decode import decode_wide_blocks


def decode_container(data: bytes, device) -> bytes:
    """Decode a wide-profile NLZP container on `device` ("cuda", "cpu",
    a torch.device), CRC-verified when the container carries a CRC.

    Raises IntegrityError on a CRC mismatch and NotImplementedError for a
    v1 (non-wide) container.
    """
    info = parse_container(data)
    if not info.comp_sizes:
        return _verified(b"", info)
    if not info.wide:
        raise NotImplementedError(
            "v1 (reference-wire) containers are not ported yet: ROADMAP.md queue A item 9"
        )
    out = decode_wide_blocks(
        block_payloads(data, info), info.block_size, info.total_len,
        info.wide_priors, info.total_reads, info.dictionary or None, device=device,
    )
    return _verified(out, info)
