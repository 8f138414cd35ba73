"""One seed per input stream, all derived from the run's ``--seed``, so
streams never share draws and any whole number is a valid seed."""
from __future__ import annotations

import zlib

import numpy as np


def derive(seed: int, tag: str) -> int:
    """A 62-bit seed for stream ``tag`` of run ``seed`` (negative and
    large seeds included): fits numpy's and torch's generators alike."""
    words = [abs(int(seed)) & 0xFFFFFFFF, (abs(int(seed)) >> 32) & 0xFFFFFFFF,
             int(seed < 0), zlib.crc32(tag.encode())]
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(state[0]) << 30) ^ int(state[1])
