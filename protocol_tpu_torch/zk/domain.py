"""Radix-2 NTT evaluation domains over BN254 Fr.

The reference gets polynomial FFTs from halo2's ``EvaluationDomain``
(used throughout keygen/prove, ``eigentrust-zk/src/utils.rs``). This is
the framework's own host implementation: iterative in-place radix-2
Cooley–Tukey over the 2-adic subgroup of Fr* (Fr has 2-adicity 28), with
coset evaluation for quotient construction.

Host ints here are the correctness oracle; the device twin (the
four-step NTT on int8 limb planes) lives in
``protocol_tpu_torch.ops.ntt_tpu``.
"""

from __future__ import annotations

from functools import lru_cache

from ..utils.fields import BN254_FR_MODULUS

R = BN254_FR_MODULUS
TWO_ADICITY = 28


@lru_cache(maxsize=None)
def _root_of_unity_max() -> int:
    """A primitive 2^28-th root of unity: c^((r−1)/2^28) for the first
    small c whose image has exact order 2^28 (checked, not assumed)."""
    odd = (R - 1) >> TWO_ADICITY
    for c in range(2, 100):
        omega = pow(c, odd, R)
        if pow(omega, 1 << (TWO_ADICITY - 1), R) != 1:
            return omega
    raise RuntimeError("no 2-adic generator found")


def root_of_unity(k: int) -> int:
    """Primitive 2^k-th root of unity."""
    assert 0 <= k <= TWO_ADICITY
    return pow(_root_of_unity_max(), 1 << (TWO_ADICITY - k), R)


def ntt(values: list, omega: int) -> list:
    """In-place-style iterative radix-2 NTT; returns evaluations in
    bit-natural order (standard CT with bit-reversal permutation)."""
    n = len(values)
    assert n & (n - 1) == 0, "NTT size must be a power of two"
    a = list(values)
    # bit-reverse permute
    j = 0
    for i in range(1, n):
        bit = n >> 1
        while j & bit:
            j ^= bit
            bit >>= 1
        j |= bit
        if i < j:
            a[i], a[j] = a[j], a[i]
    length = 2
    while length <= n:
        wlen = pow(omega, n // length, R)
        for start in range(0, n, length):
            w = 1
            half = length >> 1
            for i in range(start, start + half):
                u = a[i]
                v = a[i + half] * w % R
                a[i] = (u + v) % R
                a[i + half] = (u - v) % R
                w = w * wlen % R
        length <<= 1
    return a


def intt(values: list, omega: int) -> list:
    n = len(values)
    n_inv = pow(n, -1, R)
    out = ntt(values, pow(omega, -1, R))
    return [x * n_inv % R for x in out]


class EvaluationDomain:
    """Order-2^k multiplicative subgroup H with FFT/coset-FFT helpers."""

    def __init__(self, k: int):
        self.k = k
        self.n = 1 << k
        self.omega = root_of_unity(k)
        self.omega_inv = pow(self.omega, -1, R)
        self.n_inv = pow(self.n, -1, R)

    def elements(self) -> list:
        out = [1] * self.n
        for i in range(1, self.n):
            out[i] = out[i - 1] * self.omega % R
        return out

    def fft(self, coeffs: list) -> list:
        """Coefficients (low-first, padded) → evaluations over H."""
        padded = list(coeffs) + [0] * (self.n - len(coeffs))
        assert len(padded) == self.n, "poly degree exceeds domain"
        return ntt(padded, self.omega)

    def ifft(self, evals: list) -> list:
        return intt(evals, self.omega)

    def coset_fft(self, coeffs: list, shift: int) -> list:
        """Evaluations over the coset shift·H: scale coeffs by shiftⁱ."""
        padded = list(coeffs) + [0] * (self.n - len(coeffs))
        assert len(padded) == self.n, "poly degree exceeds domain"
        s = 1
        scaled = []
        for c in padded:
            scaled.append(c * s % R)
            s = s * shift % R
        return ntt(scaled, self.omega)

    def coset_ifft(self, evals: list, shift: int) -> list:
        coeffs = intt(evals, self.omega)
        sinv = pow(shift, -1, R)
        s = 1
        out = []
        for c in coeffs:
            out.append(c * s % R)
            s = s * sinv % R
        return out

    def vanishing_eval(self, x: int) -> int:
        """Z_H(x) = xⁿ − 1."""
        return (pow(x, self.n, R) - 1) % R

    def lagrange_evals(self, x: int, indices) -> dict:
        """L_i(x) = ωⁱ(xⁿ−1) / (n(x−ωⁱ)) for the requested indices."""
        zh = self.vanishing_eval(x)
        out = {}
        for i in indices:
            wi = pow(self.omega, i, R)
            out[i] = wi * zh % R * pow(self.n * (x - wi) % R, -1, R) % R
        return out


def poly_eval(coeffs: list, x: int) -> int:
    """Horner evaluation of a low-first coefficient list."""
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % R
    return acc


def poly_divide_linear(coeffs: list, z: int) -> list:
    """(f(X) − f(z)) / (X − z) by synthetic division; exact by design."""
    out = [0] * (len(coeffs) - 1) if len(coeffs) > 1 else []
    acc = 0
    for i in range(len(coeffs) - 1, 0, -1):
        acc = (acc * z + coeffs[i]) % R
        out[i - 1] = acc
    return out
