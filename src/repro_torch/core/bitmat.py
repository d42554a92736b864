"""Bit-packed matrix utilities.

Port of ``src/repro/core/bitmat.py``: a NumPy copy,
kept here because the port imports nothing of the JAX package.

Bit order convention (fixed across the whole repo, host and device):
column ``c`` of the adjacency matrix lives in word ``c // 32`` at bit
``c % 32`` (LSB-first within a word). numpy's ``packbits(bitorder='little')``
plus a little-endian uint8→uint32 view realizes exactly this on every platform
we run on (x86/ARM hosts; TPU consumes the words as opaque uint32 payloads).

The MRAM analogue: one uint32 word == 32 bit-cells on a word line. The paper's
|S|=64-bit slice == 2 words (``WORDS_PER_SLICE`` when slice_bits=64).
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "WORD_BITS",
    "words_for_bits",
    "bitpack_matrix",
    "bitunpack_matrix",
    "popcount_u32",
]

WORD_BITS = 32


def words_for_bits(nbits: int) -> int:
    return (int(nbits) + WORD_BITS - 1) // WORD_BITS


def bitpack_matrix(dense: np.ndarray) -> np.ndarray:
    """[n, c] bool/0-1 -> [n, ceil(c/32)] uint32, LSB-first per word."""
    dense = np.asarray(dense, dtype=np.uint8)
    n, c = dense.shape
    w = words_for_bits(c)
    pad = w * WORD_BITS - c
    if pad:
        dense = np.pad(dense, ((0, 0), (0, pad)))
    packed8 = np.packbits(dense, axis=1, bitorder="little")  # [n, w*4] uint8
    return np.ascontiguousarray(packed8).view("<u4").reshape(n, w)


def bitunpack_matrix(packed: np.ndarray, nbits: int) -> np.ndarray:
    """[n, w] uint32 -> [n, nbits] uint8 (0/1), inverse of bitpack_matrix."""
    n, w = packed.shape
    bytes_ = packed.astype("<u4").view(np.uint8).reshape(n, w * 4)
    bits = np.unpackbits(bytes_, axis=1, bitorder="little")
    return bits[:, :nbits]


_POP8 = np.array([bin(i).count("1") for i in range(256)], dtype=np.uint32)


def popcount_u32(x: np.ndarray) -> np.ndarray:
    """Per-element popcount of a uint32 array (byte-LUT; host reference).

    This is the numpy oracle for the in-kernel SWAR popcount — the same 8-bit
    LUT decomposition the paper implements as an 8→256 hardware look-up table.
    """
    b = np.asarray(x, dtype="<u4").view(np.uint8)
    return _POP8[b].reshape(*x.shape, 4).sum(axis=-1).astype(np.uint32)
