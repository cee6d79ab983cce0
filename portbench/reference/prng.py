"""A frozen copy of the port's jax-compatible threefry2x32 PRNG
(``src/repro_torch/core/prng.py``, as of the benchmark's first version;
``gumbel`` left out), so that the plain reference derives the hash
parameters and the entropy offsets from the configuration's seed without
importing the program.  The port's own docstring follows.

A jax-compatible threefry2x32 PRNG on torch tensors.

The index derives its hash parameters and its entropy offsets from
``jax.random`` keys (``PRNGKey(seed)`` -> ``split`` -> ``fold_in``), and
every shard must regenerate the same offsets for a query id.  torch's own
generators cannot reproduce those streams, so this module re-implements
the threefry2x32 counter-based generator in jax's *partitionable* mode
(``jax_threefry_partitionable=True``): a draw of shape ``shape`` hashes
the 64-bit counters ``0 .. prod(shape)-1`` split into (hi, lo) uint32
words, and 32-bit draws are ``bits1 ^ bits2``.

A key is an int64 tensor of shape ``(..., 2)`` holding two uint32 words.
torch has no full uint32 arithmetic, so every uint32 operation runs in
int64 and is masked back to 32 bits.  Leading key dimensions batch: a
``(R, 2)`` key stack draws ``(R, *shape)`` values, row i equal to the
draw of key i alone (that is how the receive side regenerates the offsets
of R routed rows at once).

``uniform``, ``randint`` and the bits are bitwise equal to jax.
``normal`` is ``sqrt(2) * erfinv(u)`` evaluated the way XLA's CPU
backend evaluates it: Giles' float32 polynomial over a Cephes ``log1p``,
with the multiply-adds XLA contracts done as fused multiply-adds.  It
matches jax bitwise on all but a handful of draws in a million, and
within 2 ulp everywhere (tested).
"""
from __future__ import annotations

import functools
import math

import torch


M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA


def mul_u32(a: torch.Tensor, b) -> torch.Tensor:
    """(a * b) mod 2**32 for uint32 values held in int64.  The full
    product can reach 2**64 and overflow int64, so b is split into 16-bit
    halves and each partial product is masked to 32 bits."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & M32) << 16
    return (lo + hi) & M32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The threefry2x32 block function (20 rounds) on broadcast int64
    tensors holding uint32 values; same schedule as jax's lowering."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x = [(x1 + ks[0]) & M32, (x2 + ks[1]) & M32]
    for i in range(5):
        for r in _ROT[i % 2]:
            x[0] = (x[0] + x[1]) & M32
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & M32
        x[1] = (x[1] + ks[(i + 2) % 3] + (i + 1)) & M32
    return x[0], x[1]


def PRNGKey(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a seed in the int32 range."""
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: (num, 2) keys from one (2,) key."""
    lo = torch.arange(num, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[0], key[1], torch.zeros_like(lo), lo)
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` batched over leading dims: key (..., 2) and
    data (...) integer (uint32 after masking) -> keys (..., 2)."""
    data = torch.as_tensor(data, dtype=torch.int64,
                           device=key.device) & M32
    b1, b2 = threefry2x32(key[..., 0], key[..., 1],
                          torch.zeros_like(data), data)
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32-bit draws (as int64 in [0, 2**32)) of shape key.shape[:-1] +
    shape, counters in row-major order over ``shape``."""
    shape = tuple(shape)
    n = math.prod(shape)
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    batch = key.shape[:-1]
    k1 = key[..., 0].reshape(batch + (1,))
    k2 = key[..., 1].reshape(batch + (1,))
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return (b1 ^ b2).reshape(batch + shape)


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 square root rounded once (taken in float64), on every
    device (``src/repro_torch/kernels/types.py:32``)."""
    return torch.sqrt(x.double()).float()


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 fused multiply-add: the float64 product of two float32
    values is exact, so one float64 add and one rounding to float32 give
    fma(a, b, c) (up to a double-rounding tie, which does not occur in
    practice).  XLA contracts these multiply-adds on the CPU."""
    a = a.double()
    b = b.double() if torch.is_tensor(b) else b
    c = c.double() if torch.is_tensor(c) else c
    return (a * b + c).float()


@functools.lru_cache(maxsize=None)
def _const(values, device: torch.device) -> torch.Tensor:
    """A float32 constant (a float or a tuple of floats) on ``device``,
    copied there once: a copy from pageable host memory waits for every
    kernel queued on the device (a host sync), and the query path draws
    offsets twice a batch."""
    return torch.tensor(values, dtype=torch.float32, device=device)


def _bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """uint32 draws -> float32 in [0, 1): random mantissa, exponent 0."""
    fb = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return fb.view(torch.float32) - 1.0


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32 (bitwise)."""
    lo = _const(float(minval), key.device)
    hi = _const(float(maxval), key.device)
    f = _bits_to_unit(random_bits(key, shape))
    # XLA contracts the scale-and-shift into one fused multiply-add
    return torch.maximum(lo, _fma(f, hi - lo, lo))


# log(1 + x) as XLA's CPU backend evaluates it in float32: a Cephes
# rational for |x| < sqrt(2) - 1, else log(1 + x) with Cephes' logf
_LOG1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
              6.5787325942061044846969E0, 2.9911919328553073277375E1,
              6.0949667980987787057556E1, 5.7112963590585538103336E1,
              2.0039553499201281259648E1)
_LOG1P_DEN = (1., 1.5062909083469192043167E1, 8.3047565967967209469434E1,
              2.2176239823732856465394E2, 3.0909872225312059774938E2,
              2.1642788614495947685003E2, 6.0118660497603843919306E1)


def _f32(v: float) -> float:
    return float(torch.tensor(v, dtype=torch.float32))


def _horner(x: torch.Tensor, coeffs) -> torch.Tensor:
    p = torch.zeros_like(x)
    for c in coeffs:
        p = _fma(p, x, _f32(c))
    return p


def _log_f32(x: torch.Tensor) -> torch.Tensor:
    """Cephes logf for positive normal float32 inputs."""
    m, e = torch.frexp(x)
    e = e.to(torch.float32)
    small = m < 0.707106781186547524
    e = e - small.to(torch.float32)
    m = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    x2 = m * m
    x3 = x2 * m
    y = _fma(m, _f32(7.0376836292E-2), _f32(-1.1514610310E-1))
    y1 = _fma(m, _f32(-1.2420140846E-1), _f32(1.4249322787E-1))
    y2 = _fma(m, _f32(2.0000714765E-1), _f32(-2.4999993993E-1))
    y = _fma(y, m, _f32(1.1676998740E-1))
    y1 = _fma(y1, m, _f32(-1.6668057665E-1))
    y2 = _fma(y2, m, _f32(3.3333331174E-1))
    y = _fma(y, x3, y1)
    y = _fma(y, x3, y2)
    y = _fma(y, x3, e * _f32(-2.12194440e-4))
    m = (m - x2 * 0.5) + y
    return m + e * _f32(0.693359375)


def _log1p_f32(x: torch.Tensor) -> torch.Tensor:
    x2 = x * x
    r = _horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN)
    small = x + ((-0.5 * x2) + (x * x2) * r)
    return torch.where(x.abs() < 0.41421356237309504880, small,
                       _log_f32(x + 1.0))


# Giles' single-precision erfinv, the coefficients XLA's ErfInv uses
_W_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
          0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
          1.50140941)
_W_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
          0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
          2.83297682)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function, evaluated as XLA evaluates it on
    the CPU (``torch.erfinv`` rounds differently on 59% of normal draws)."""
    w = -_log1p_f32(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, sqrt_f32(w) - 3.0)
    c_lt = _const(tuple(_W_LT5), x.device)
    c_ge = _const(tuple(_W_GE5), x.device)
    p = torch.where(lt, c_lt[0], c_ge[0])
    for i in range(1, len(_W_LT5)):
        p = _fma(p, w, torch.where(lt, c_lt[i], c_ge[i]))
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


_SQRT2 = float(torch.tensor(math.sqrt(2.0), dtype=torch.float32))
_NORMAL_LO = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))


def normal(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.normal`` in float32 (within 2 ulp, see module doc)."""
    u = uniform(key, shape, _NORMAL_LO, 1.0)
    return _SQRT2 * erfinv(u)


def randint(key: torch.Tensor, shape, minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint(..., dtype=int32)`` (bitwise), for
    ``INT32_MIN <= minval < maxval <= INT32_MAX``."""
    if not -2**31 <= minval < maxval <= 2**31 - 1:
        raise ValueError(f"need int32 bounds, got [{minval}, {maxval})")
    k = split(key, 2)
    higher = random_bits(k[0], shape)
    lower = random_bits(k[1], shape)
    span = (maxval - minval) & M32
    # jax forms 2**32 mod span in uint32 arithmetic, which wraps to zero
    # once span > 2**16; reproduce that exactly
    mult = (2 ** 16) % span
    mult = ((mult * mult) & M32) % span
    off = (mul_u32(higher % span, mult) + lower % span) & M32
    off = off % span
    return (minval + off).to(torch.int32)
