"""ChaCha20 host RNG bit-compatible with the `rand` crate (the benchmark's
frozen copy of raytrace_tpu_torch/tools/chacha.py, so the scene generator
beside it imports nothing of the program).

The reference seeds a thread-local `rand_chacha::ChaCha20Rng` with
`SeedableRng::seed_from_u64(485674845675491)` (random/src/lib.rs:15-33,
tools/src/main.rs:25) and draws scene-generation randomness through rand's
distributions.  Reproducing the shipped assets/final-one-weekend*.json
sphere-for-sphere therefore needs three exact pieces (rand 0.9.1 /
rand_chacha 0.9.0 / rand_core 0.9.3, per the reference Cargo.lock):

1. `seed_from_u64`: rand_core expands the u64 into the 32-byte ChaCha key
   with a PCG32 stream (documented-stable across rand_core versions);
2. the ChaCha20 block function (djb variant: 64-bit block counter in
   words 12-13, 64-bit stream id in words 14-15, stream 0), words output
   in sequential block order;
3. rand's float conversions: `random::<f32>()` takes the top 24 bits of a
   u32 times 2^-24; `random_range(lo..hi)` builds a mantissa float in
   [1,2) from the top 23 bits and maps `(value-1)*scale + lo`.

Pure Python: scene generation draws a few thousand values.
"""

from __future__ import annotations

import struct

_M64 = (1 << 64) - 1
_M32 = (1 << 32) - 1

_CONSTANTS = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)


def _pcg32_seed_bytes(state: int, n: int) -> bytes:
    """rand_core's `seed_from_u64` filler: PCG32 (XSH-RR) 4 bytes at a
    time, little-endian."""
    mul = 6364136223846793005
    inc = 11634580027462260723
    out = bytearray()
    while len(out) < n:
        state = (state * mul + inc) & _M64
        xorshifted = (((state >> 18) ^ state) >> 27) & _M32
        rot = state >> 59
        x = ((xorshifted >> rot) | (xorshifted << (32 - rot))) & _M32
        out += struct.pack("<I", x)
    return bytes(out[:n])


def _quarter(x, a, b, c, d):
    x[a] = (x[a] + x[b]) & _M32
    x[d] = ((x[d] ^ x[a]) << 16 | (x[d] ^ x[a]) >> 16) & _M32
    x[c] = (x[c] + x[d]) & _M32
    x[b] = ((x[b] ^ x[c]) << 12 | (x[b] ^ x[c]) >> 20) & _M32
    x[a] = (x[a] + x[b]) & _M32
    x[d] = ((x[d] ^ x[a]) << 8 | (x[d] ^ x[a]) >> 24) & _M32
    x[c] = (x[c] + x[d]) & _M32
    x[b] = ((x[b] ^ x[c]) << 7 | (x[b] ^ x[c]) >> 25) & _M32


def _chacha20_block(key_words, counter: int, stream: int):
    """One 64-byte ChaCha20 block -> 16 little-endian u32 output words."""
    state = list(_CONSTANTS) + list(key_words) + [
        counter & _M32, (counter >> 32) & _M32,
        stream & _M32, (stream >> 32) & _M32,
    ]
    x = state[:]
    for _ in range(10):                      # 20 rounds = 10 double rounds
        _quarter(x, 0, 4, 8, 12)
        _quarter(x, 1, 5, 9, 13)
        _quarter(x, 2, 6, 10, 14)
        _quarter(x, 3, 7, 11, 15)
        _quarter(x, 0, 5, 10, 15)
        _quarter(x, 1, 6, 11, 12)
        _quarter(x, 2, 7, 8, 13)
        _quarter(x, 3, 4, 9, 14)
    return [(x[i] + state[i]) & _M32 for i in range(16)]


class ChaCha20Rng:
    """Word-stream-compatible stand-in for rand_chacha's ChaCha20Rng."""

    def __init__(self, seed32: bytes, stream: int = 0):
        assert len(seed32) == 32
        self.key = struct.unpack("<8I", seed32)
        self.stream = stream
        self.counter = 0
        self.buf: list[int] = []

    @classmethod
    def seed_from_u64(cls, seed: int) -> "ChaCha20Rng":
        return cls(_pcg32_seed_bytes(seed & _M64, 32))

    def next_u32(self) -> int:
        if not self.buf:
            self.buf = _chacha20_block(self.key, self.counter, self.stream)
            self.counter += 1
        return self.buf.pop(0)

    # --- rand 0.9 distribution semantics ---

    def f32(self) -> float:
        """StandardUniform f32: top 24 bits * 2^-24 (float_impls.rs)."""
        import numpy as np

        return float(np.float32(self.next_u32() >> 8)
                     * np.float32(1.0 / (1 << 24)))

    def f32_range(self, low: float, high: float) -> float:
        """UniformFloat<f32>::sample_single: mantissa float in [1,2) from
        the top 23 bits, then (value-1)*scale + low in f32 arithmetic."""
        import numpy as np

        bits = (self.next_u32() >> 9) | 0x3F800000
        value1_2 = np.frombuffer(struct.pack("<I", bits),
                                 dtype=np.float32)[0]
        scale = np.float32(high) - np.float32(low)
        return float((value1_2 - np.float32(1.0)) * scale + np.float32(low))

    def vec3(self):
        return [self.f32(), self.f32(), self.f32()]

    def vec3_in_range(self, low: float, high: float):
        return [self.f32_range(low, high) for _ in range(3)]
