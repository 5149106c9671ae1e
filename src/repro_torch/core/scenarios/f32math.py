"""Float32 ``exp``, ``ndtri`` and ``sin`` as the reference computes them.

The scenario layer turns uniform draws into latencies,
``exp(sigma * ndtri(u))``, and then compares them with a deadline or
divides the deadline by them (``core/scenarios/builtin.py``).  Those are
threshold tests: a latency one ulp away from the reference's can flip a
device between on time and late, and a work fraction one ulp away can
move ``ceil(work * steps)``.  ``torch.exp`` and ``torch.special.ndtri``
differ from the reference's float32 results by one ulp on about one
input in ten, so this module computes them the way the reference does:

- ``exp``: Cephes' ``expf`` -- range reduction by ``ln 2`` in two parts,
  a degree-5 polynomial -- with every multiply-add fused;
- ``log``: Cephes' ``logf`` -- mantissa in ``[sqrt(1/2), sqrt(2))``, a
  degree-8 polynomial in three interleaved chains -- fused the same way;
- ``ndtri``: the reference's own Cephes rational approximations
  (``jax.scipy.special.ndtri``), its polynomials evaluated by Horner's
  rule with fused multiply-adds;
- ``sin``: correctly rounded, which is the closest this module gets to
  the reference's float32 ``sin``: they differ by an ulp on about one
  input in seventy, against one in twenty for ``torch.sin``.  It only
  sets availability probabilities, and an ulp of ``p`` flips a device
  only when its uniform falls inside that ulp (about 6e-8 a draw);
- ``sqrt``: correctly rounded.  PyTorch's float32 ``sqrt`` on the CPU is
  not (one input in a hundred and fifty is an ulp off), so it is taken
  in float64 and rounded, which is exact for a square root.

A fused multiply-add rounds once.  PyTorch has no such operation, so
:func:`fma` computes it in float64, where the product of two float32
values is exact, and rounds the sum to odd before the final rounding to
float32, which makes that double rounding exact.  Everything runs on
whatever device the input lies on; the trainer calls it on the CPU.
"""
from __future__ import annotations

import math

import torch

F32, F64 = torch.float32, torch.float64


def fma(a, b, c) -> torch.Tensor:
    """``a * b + c`` in float32, rounded once (a fused multiply-add)."""
    a, b, c = (torch.as_tensor(x, dtype=F32) for x in (a, b, c))
    prod = a.to(F64) * b.to(F64)                  # exact: 24 + 24 bits
    c64 = c.to(F64)
    s = prod + c64
    # TwoSum: s + err == prod + c64 exactly
    bv = s - prod
    err = (prod - (s - bv)) + (c64 - bv)
    # round to odd, then to nearest float32: no double-rounding error
    even = (s.view(torch.int64) & 1) == 0
    nudge = (err != 0) & even
    toward = torch.where(err > 0, torch.full_like(s, math.inf),
                         torch.full_like(s, -math.inf))
    s = torch.where(nudge, torch.nextafter(s, toward), s)
    return s.to(F32)


_EXP_P = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
          4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)


def exp(x) -> torch.Tensor:
    """float32 ``exp`` (Cephes ``expf``, fused multiply-adds)."""
    x = torch.clamp(torch.as_tensor(x, dtype=F32), -88.3762626647949,
                    88.3762626647950)
    fx = torch.floor(fma(x, 1.44269504088896341, 0.5))
    r = fma(-0.693359375, fx, x)
    r = fma(2.12194440e-4, fx, r)
    z = r * r
    y = fma(r, _EXP_P[0], _EXP_P[1])
    for c in _EXP_P[2:]:
        y = fma(y, r, c)
    y = fma(y, z, r)
    y = 1.0 + y
    return y * torch.ldexp(torch.ones_like(y), fx.to(torch.int32))


_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)


def log(x) -> torch.Tensor:
    """float32 ``log`` of positive normal inputs (Cephes ``logf``, fused
    multiply-adds)."""
    x = torch.as_tensor(x, dtype=F32)
    bits = x.view(torch.int32)
    e = ((bits >> 23) - 0x7F).to(F32) + 1.0
    m = ((bits & ~0x7F800000) | 0x3F000000).view(F32)   # in [0.5, 1)
    low = m < 0.707106781186547524
    e = e - low.to(F32)
    m = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    x2 = m * m
    x3 = x2 * m
    y0 = fma(fma(m, _LOG_P[0], _LOG_P[1]), m, _LOG_P[2])
    y1 = fma(fma(m, _LOG_P[3], _LOG_P[4]), m, _LOG_P[5])
    y2 = fma(fma(m, _LOG_P[6], _LOG_P[7]), m, _LOG_P[8])
    y = fma(fma(y0, x3, y1), x3, y2)
    y = fma(y, x3, e * -2.12194440e-4)
    out = fma(x2, -0.5, m) + y
    return fma(e, 0.693359375, out)


# Cephes' ndtri coefficients, highest power first (jax.scipy.special)
_P0 = (-5.99633501014107895267E1, 9.80010754185999661536E1,
       -5.66762857469070293439E1, 1.39312609387279679503E1,
       -1.23916583867381258016E0)
_Q0 = (1.0, 1.95448858338141759834E0, 4.67627912898881538453E0,
       8.63602421390890590575E1, -2.25462687854119370527E2,
       2.00260212380060660359E2, -8.20372256168333339912E1,
       1.59056225126211695515E1, -1.18331621121330003142E0)
_P1 = (4.05544892305962419923E0, 3.15251094599893866154E1,
       5.71628192246421288162E1, 4.40805073893200834700E1,
       1.46849561928858024014E1, 2.18663306850790267539E0,
       -1.40256079171354495875E-1, -3.50424626827848203418E-2,
       -8.57456785154685413611E-4)
_Q1 = (1.0, 1.57799883256466749731E1, 4.53907635128879210584E1,
       4.13172038254672030440E1, 1.50425385692907503408E1,
       2.50464946208309415979E0, -1.42182922854787788574E-1,
       -3.80806407691578277194E-2, -9.33259480895457427372E-4)
_P2 = (3.23774891776946035970E0, 6.91522889068984211695E0,
       3.93881025292474443415E0, 1.33303460815807542389E0,
       2.01485389549179081538E-1, 1.23716634817820021358E-2,
       3.01581553508235416007E-4, 2.65806974686737550832E-6,
       6.23974539184983293730E-9)
_Q2 = (1.0, 6.02427039364742014255E0, 3.67983563856160859403E0,
       1.37702099489081330271E0, 2.16236993594496635890E-1,
       1.34204006088543189037E-2, 3.28014464682127739104E-4,
       2.89247864745380683936E-6, 6.79019408009981274425E-9)


def sin(x) -> torch.Tensor:
    """Correctly rounded float32 sine."""
    return torch.sin(torch.as_tensor(x, dtype=F32).to(F64)).to(F32)


def sqrt(x) -> torch.Tensor:
    """Correctly rounded float32 square root."""
    return torch.sqrt(torch.as_tensor(x, dtype=F32).to(F64)).to(F32)


def _polyval(coeffs, x):
    y = torch.zeros_like(x)
    for c in coeffs:
        y = fma(y, x, c)
    return y


def _f32(v: float) -> float:
    """``v`` rounded to float32 (as the reference casts its constants)."""
    return float(torch.tensor(v, dtype=F32))


def ndtri(p) -> torch.Tensor:
    """float32 inverse of the standard normal CDF on ``[0, 1]``, in the
    reference's order of operations (``jax.scipy.special.ndtri``)."""
    p = torch.as_tensor(p, dtype=F32)
    mcp = torch.where(p > _f32(-math.expm1(-2.0)), 1.0 - p, p)
    mcp = torch.where(mcp == 0.0, torch.full_like(mcp, 0.5), mcp)
    # p > exp(-2): x / sqrt(2 pi) = w + w^3 P0(w^2) / Q0(w^2)
    w = mcp - 0.5
    ww = w * w
    big = w + w * ww * (_polyval(_P0, ww) / _polyval(_Q0, ww))
    big = big * -_f32(math.sqrt(2.0 * math.pi))
    # p <= exp(-2): x = z - log(z)/z - (1/z) P(1/z) / Q(1/z)
    z = sqrt(-2.0 * log(mcp))
    first = z - log(z) / z
    iz = 1.0 / z
    small = first - _polyval(_P2, iz) / _polyval(_Q2, iz) / z
    other = first - _polyval(_P1, iz) / _polyval(_Q1, iz) / z
    x = torch.where(mcp > _f32(math.exp(-2.0)), big,
                    torch.where(z >= 8.0, small, other))
    x = torch.where(p > _f32(1.0 - math.exp(-2.0)), x, -x)
    x = torch.where(p == 1.0, torch.full_like(x, math.inf), x)
    return torch.where(p == 0.0, torch.full_like(x, -math.inf), x)
