"""Device-side (jnp) exact GF(p) arithmetic on int32 arrays.

Everything operates on the balanced representation (see field.py) and is
designed to trace cleanly under ``jax.jit``: the Field is a static Python
value captured in the closure, so ``p`` etc. become compile-time constants.

Tiers (Field.tier):

* tier 'a' (p <= 92681): balanced products fit int32 exactly — one multiply
  plus one remainder per op.  Covers the reference's default prime 42013.
* tier 'b' (p < 2**31): 16x16 split multiply in uint32 with doubling-based
  shift-mod.  Exact for the full range; slower, used only when requested.
* tier 'c' (2**31 <= p <= 2**32 - 5): the reference's full prime range
  (src/SpaSM.jl:74).  Balanced values still fit int32 (|v| <= p/2 <
  2**31); sums and lifts can exceed 2**32, so every tier-c primitive runs
  on uint32 residues with wrap-aware modular adds (written for a device
  without native int64; whether int64 is faster on H100 is not measured)
  — the per-p carrier choice mirrors ``spasm_datatype_choose``
  (src/SpaSM.jl:810).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..field import Field

_MAX_DEVICE_P = 0xFFFFFFFB  # full reference range (src/SpaSM.jl:74)


def check_device_prime(f: Field) -> None:
    if f.p > _MAX_DEVICE_P:
        raise NotImplementedError(
            f"device arithmetic supports p <= {_MAX_DEVICE_P}; got p={f.p}")


def normalize(f: Field, x):
    """Map int32/int64 values into the balanced range.  `x` must be exact
    (no prior overflow)."""
    if f.tier == "c":
        return _normalize_tier_c(f, x)
    p = x.dtype.type(f.p)
    r = jnp.remainder(x, p)  # [0, p)
    r = jnp.where(r > x.dtype.type(f.halfp), r - p, r)
    return r.astype(jnp.int32)


def add(f: Field, a, b):
    # balanced inputs: |a+b| <= p < 2**32 — compute in int32 when safe
    if f.p <= (1 << 30):
        return normalize(f, a + b)  # |a+b| <= p <= 2**30, exact int32
    if f.tier == "c":
        return _from_unsigned_c(f, _addmod_c(f, _to_unsigned_c(f, a),
                                             _to_unsigned_c(f, b)))
    s = a.astype(jnp.int64) + b.astype(jnp.int64)
    return normalize(f, s)


def sub(f: Field, a, b):
    if f.p <= (1 << 30):
        return normalize(f, a - b)
    if f.tier == "c":
        return add(f, a, -b)  # balanced range is symmetric: -b is balanced
    s = a.astype(jnp.int64) - b.astype(jnp.int64)
    return normalize(f, s)


def neg(f: Field, a):
    return -a  # balanced range is symmetric enough: |a| <= p//2, so is -a


def mul(f: Field, a, b):
    check_device_prime(f)
    if f.tier == "a":
        return normalize(f, a * b)  # (p//2)**2 < 2**31, exact int32
    if f.tier == "c":
        return _mul_tier_c(f, a, b)
    return _mul_tier_b(f, a, b)


def axpy(f: Field, a, x, y):
    """a*x + y with one reduction (reference axpy, src/SpaSM.jl:387-390)."""
    check_device_prime(f)
    if f.tier == "a":
        # |a*x| < 2**31 and |y| <= p/2 — the sum can exceed int32.  Reduce the
        # product first (still one extra add-normalize, but stays in int32).
        return add(f, normalize(f, a * x), y)
    if f.tier == "c":
        return add(f, _mul_tier_c(f, a, x), y)
    return add(f, _mul_tier_b(f, a, x), y)


# ---------------- tier B: 16x16 split multiply (p < 2**31) ----------------


def _to_unsigned(f: Field, a):
    """balanced int32 -> uint32 in [0, p).  |a| <= p//2 < 2**30 and
    p <= 2**31 - 1, so a + p fits int32 exactly."""
    lifted = jnp.where(a < 0, a + jnp.int32(f.p), a)
    return lifted.astype(jnp.uint32)


def _from_unsigned(f: Field, u):
    """uint32 in [0, p) -> balanced int32.  u < p <= 2**31 - 1 so the
    signed conversion is in-range."""
    s = u.astype(jnp.int32)
    return jnp.where(s > jnp.int32(f.halfp), s - jnp.int32(f.p), s)


def _addmod_u32(f: Field, x, y):
    # x, y in [0, p), p < 2**31 -> x + y < 2**32: exact in uint32
    s = x + y
    p = jnp.uint32(f.p)
    return jnp.where(s >= p, s - p, s)


def _dblmod_u32(f: Field, x):
    return _addmod_u32(f, x, x)


def _shiftmod_u32(f: Field, x, k: int):
    for _ in range(k):
        x = _dblmod_u32(f, x)
    return x


def _modu32_barrett(f: Field, v):
    """v mod p for uint32 v < 2**32, tier-B p (92681 < p < 2**31):
    float-Barrett quotient — the f32 conversion error of v is <= 256,
    i.e. < 0.01 quotients for tier-B p, so round() yields q_true or
    q_true + 1 — exact wrap-around multiply-subtract, one conditional
    +p correction.  Far cheaper than the integer `%` (division)."""
    pu = jnp.uint32(f.p)
    q = jnp.round(v.astype(jnp.float32)
                  * jnp.float32(1.0 / f.p)).astype(jnp.uint32)
    r = v - q * pu
    return jnp.where(r > jnp.uint32(1 << 31), r + pu, r)


def _mul_tier_b(f: Field, a, b):
    au = _to_unsigned(f, a)
    bu = _to_unsigned(f, b)
    mask = jnp.uint32(0xFFFF)
    a1, a0 = au >> 16, au & mask
    b1, b0 = bu >> 16, bu & mask
    t_lo = _modu32_barrett(f, a0 * b0)             # < 2**32, exact
    t_mid = _modu32_barrett(f, a1 * b0 + a0 * b1)  # sum < 2**32, exact
    t_hi = _modu32_barrett(f, a1 * b1)             # < 2**30
    r = _shiftmod_u32(f, t_hi, 16)
    r = _addmod_u32(f, r, t_mid)
    r = _shiftmod_u32(f, r, 16)
    r = _addmod_u32(f, r, t_lo)
    return _from_unsigned(f, r)


# ------------- tier C: full range 2**31 <= p <= 2**32 - 5 -------------
#
# No int64: every step stays in uint32 residues [0, p).
# Sums x + y with x, y < p can wrap past 2**32; _addmod_c detects the wrap
# (s < x iff wrapped) — a wrapped sum is >= 2**32 > p, and s - p computed
# in uint32 un-wraps exactly because the true value x + y - p < p < 2**32.


def _to_unsigned_c(f: Field, a):
    """balanced int32 -> uint32 residue in [0, p).  For a < 0 the bitcast
    gives a + 2**32; adding p wraps back to a + p (exact: a + p >= 0 and
    a + 2**32 + p >= 2**32)."""
    u = jax.lax.bitcast_convert_type(a, jnp.uint32)
    return jnp.where(a < 0, u + jnp.uint32(f.p), u)


def _from_unsigned_c(f: Field, u):
    """uint32 residue in [0, p) -> balanced int32.  Values > p/2 map to
    u - p = -(p - u), with p - u <= p/2 + 1 < 2**31 computed in uint32."""
    high = u > jnp.uint32(f.halfp)
    neg_mag = jax.lax.bitcast_convert_type(jnp.uint32(f.p) - u, jnp.int32)
    pos = jax.lax.bitcast_convert_type(u, jnp.int32)
    return jnp.where(high, -neg_mag, pos)


def _addmod_c(f: Field, x, y):
    s = x + y  # may wrap mod 2**32
    p = jnp.uint32(f.p)
    ge = (s < x) | (s >= p)
    return jnp.where(ge, s - p, s)


def _shiftmod_c(f: Field, x, k: int):
    for _ in range(k):
        x = _addmod_c(f, x, x)
    return x


def _mul_tier_c(f: Field, a, b):
    """Exact balanced product for 2**31 <= p <= 2**32 - 5 via a 16x16
    split: a*b = ((a1*b1 << 16) + a1*b0 + a0*b1 << 16) + a0*b0 with each
    partial reduced mod p in uint32 (partials < 2**32, exact) and the
    shifts done as wrap-aware doublings."""
    p = jnp.uint32(f.p)
    au = _to_unsigned_c(f, a)
    bu = _to_unsigned_c(f, b)
    mask = jnp.uint32(0xFFFF)
    a1, a0 = au >> 16, au & mask
    b1, b0 = bu >> 16, bu & mask
    t_hi = (a1 * b1) % p   # < 2**32, exact uint32 product
    m1 = (a1 * b0) % p
    m2 = (a0 * b1) % p
    t_lo = (a0 * b0) % p
    r = _shiftmod_c(f, t_hi, 16)
    r = _addmod_c(f, r, m1)
    r = _addmod_c(f, r, m2)
    r = _shiftmod_c(f, r, 16)
    r = _addmod_c(f, r, t_lo)
    return _from_unsigned_c(f, r)


def _normalize_tier_c(f: Field, x):
    """Any int32 (or int64 when x64 is enabled) -> balanced.  For int32
    input |x| < 2**31 <= p, so x is already in (-p, p): a single
    conditional +-p fold lands in the balanced range."""
    if x.dtype == jnp.int32:
        u = _to_unsigned_c(f, x)  # (-p, p) -> [0, p) exactly
        return _from_unsigned_c(f, u)
    # wider input (int64 path exists only under jax_enable_x64)
    p = x.dtype.type(f.p)
    r = jnp.remainder(x, p)
    r = jnp.where(r > x.dtype.type(f.halfp), r - p, r)
    return r.astype(jnp.int32)


def inv_scalar(f: Field, x):
    """Modular inverse of a (0-d) device value via Fermat: x**(p-2) mod p.
    p is prime, so this matches the reference's extended-gcd inverse
    (src/SpaSM.jl:386) on nonzero inputs; returns 0 for x == 0.

    Tier A unrolls the square-and-multiply (each multiply is two
    operations).  Tiers B and C run it as a loop over the exponent's
    bits: unrolled, their ~60 split multiplies made every panel step's
    program thousands of operations long, and compiling a 1024^2 tier-B
    dense RREF took minutes on the GPU."""
    check_device_prime(f)
    e = f.p - 2
    if f.tier == "a":
        result = jnp.int32(1)
        base = x
        while e:
            if e & 1:
                result = mul(f, result, base)
            base = mul(f, base, base)
            e >>= 1
        return result
    bits = jnp.array([(e >> i) & 1 for i in range(e.bit_length())],
                     jnp.int32)

    def body(i, carry):
        result, base = carry
        result = jnp.where(bits[i] == 1, mul(f, result, base), result)
        return result, mul(f, base, base)

    result, _ = jax.lax.fori_loop(0, bits.shape[0], body,
                                  (jnp.ones_like(x), x))
    return result


# ---------------- int8 limb (de)composition for the matmul -------------


def to_limbs(f: Field, x, nl: int):
    """Decompose balanced int32 values into `nl` balanced base-256 limbs
    (each in [-128, 127] — the full int8 range), so that
    ``x == sum_i limbs[i] * 256**i``.

    Returns an array of shape ``x.shape + (nl,)``, dtype int8.  This is the
    entry format for the int8 modular matmul (ops/matmul.py): base 256
    needs only 2 limbs (4 int8 products) for p <= 65792, vs 3 limbs (9
    products) in base 128.
    """
    limbs = []
    v = x.astype(jnp.int32)
    for _ in range(nl):
        low = v & 255
        l = (low ^ 128) - 128  # sign-extended low byte in [-128, 127]
        limbs.append(l.astype(jnp.int8))
        # v' = (v - l) / 256 without intermediate overflow at the int32
        # extremes (tier-c balanced values reach +-(2**31 - 3)):
        # v - l = 256*(v >> 8) + 256*(low >> 7)
        v = (v >> 8) + (low >> 7)
    return jnp.stack(limbs, axis=-1)


def limb_weights(f: Field, nl: int):
    """(256**(i+j)) mod p as balanced int32, for combining limb products."""
    w = [pow(256, s, f.p) for s in range(2 * nl - 1)]
    w = [x - f.p if x > f.halfp else x for x in w]
    return jnp.array(w, dtype=jnp.int32)
