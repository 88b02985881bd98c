"""Emulator for glibc's ``random()``/``rand()`` (TYPE_3 additive-feedback).

The reference derives *all* protocol randomness from the glibc generator:
input witness values from the default-seeded stream during parsing
(reference src/main.cpp:188 — before any srand call, i.e. seed 1),
then ``srand(3396)`` in ``fieldElement::init`` (fieldElement.cpp:106-111)
reseeds, and every subsequent ``F::random()`` (fieldElement.cpp:362-367)
and FRI query position ``rand() % n`` (lib/virgo/src/vpd_verifier.cpp:121)
draws from that stream in program order.  Emulating it exactly enables
bit-identical transcript parity tests against the C++ binary.

Algorithm (glibc stdlib/random_r.c, TYPE_3: DEG=31, SEP=3):
  state r[0..30];  r[0]=seed;  r[i] = 16807*r[i-1] mod 2147483647
  (computed via Schrage to stay in int32), then 310 warm-up outputs are
  discarded; each output is r[k] = r[k-31] + r[k-3] (mod 2^32) >> 1.
"""

from __future__ import annotations

MOD61 = (1 << 61) - 1


class GlibcRandom:
    def __init__(self, seed: int = 1):
        self.seed(seed)

    def seed(self, seed: int):
        seed &= 0xFFFFFFFF
        if seed == 0:
            seed = 1
        r = [0] * 31  # TYPE_3 ring: DEG=31 entries
        r[0] = seed
        for i in range(1, 31):
            # Schrage: (16807 * r[i-1]) % 2147483647 without overflow
            hi, lo = divmod(r[i - 1], 127773)
            word = 16807 * lo - 2836 * hi
            if word < 0:
                word += 2147483647
            r[i] = word
        self._state = r
        self._fptr = 3  # rand_sep
        self._rptr = 0
        for _ in range(310):  # 10 * DEG warm-up outputs discarded
            self._next()

    def _next(self) -> int:
        r = self._state
        val = (r[self._fptr] + r[self._rptr]) & 0xFFFFFFFF
        r[self._fptr] = val
        self._fptr += 1
        if self._fptr >= 31:
            self._fptr = 0
        self._rptr += 1
        if self._rptr >= 31:
            self._rptr = 0
        return val >> 1

    def random(self) -> int:
        """glibc random(): 31-bit output."""
        return self._next()

    rand = random  # glibc rand() is the same generator

    def field_random(self):
        """fieldElement::randomNumber (fieldElement.cpp:362-367): build a
        20-digit decimal from successive ``random() % 10`` draws, reducing
        mod p at each step."""
        ret = self.random() % 10
        for _ in range(1, 20):
            # NB: the reference computes ret*10 in uint64, which wraps mod
            # 2^64 before the % mod — reproduce that exactly.
            ret = (((ret * 10) & 0xFFFFFFFFFFFFFFFF) + self.random() % 10) % MOD61
        return ret

    def field_element(self):
        """fieldElement::random (fieldElement.cpp:119-124): real then img,
        each randomNumber() % mod."""
        real = self.field_random() % MOD61
        img = self.field_random() % MOD61
        return real, img
