"""Host-side exact oracle for GF((2^61-1)^2), used only by tests.

Pure python-int implementation mirroring the semantics of the reference
arithmetic (reference lib/virgo/src/fieldElement.cpp) including its
canonical-range behaviour, so the tensor implementation can be verified
element-by-element.
"""

from __future__ import annotations

MOD = (1 << 61) - 1


class Fq2:
    __slots__ = ("real", "img")

    def __init__(self, real=0, img=0):
        self.real = real % MOD if real >= 0 else (MOD + real) % MOD
        self.img = img % MOD if img >= 0 else (MOD + img) % MOD

    @staticmethod
    def raw(real, img):
        e = Fq2()
        e.real, e.img = real, img
        return e

    def __add__(self, o):
        return Fq2.raw((self.real + o.real) % MOD, (self.img + o.img) % MOD)

    def __sub__(self, o):
        return Fq2.raw((self.real - o.real) % MOD, (self.img - o.img) % MOD)

    def __neg__(self):
        return Fq2.raw((-self.real) % MOD, (-self.img) % MOD)

    def __mul__(self, o):
        ac = self.real * o.real % MOD
        bd = self.img * o.img % MOD
        allp = (self.real + self.img) * (o.real + o.img) % MOD
        return Fq2.raw((ac - bd) % MOD, (allp - ac - bd) % MOD)

    def __eq__(self, o):
        return self.real == o.real and self.img == o.img

    def __hash__(self):
        return hash((self.real, self.img))

    def __repr__(self):
        return f"({self.real} {self.img})"

    def inv(self):
        return self.pow(MOD * MOD - 2)

    def pow(self, e):
        r, b = Fq2.raw(1, 0), self
        while e:
            if e & 1:
                r = r * b
            b = b * b
            e >>= 1
        return r

    def is_zero(self):
        return self.real == 0 and self.img == 0


ZERO = Fq2.raw(0, 0)
ONE = Fq2.raw(1, 0)


def root_of_unity(log_order: int) -> Fq2:
    rou = Fq2.raw(2147483648, 1033321771269002680)
    for _ in range(62 - log_order):
        rou = rou * rou
    return rou
