"""Compensated reductions for single-precision accuracy parity.

Counterpart of the compensated half of the JAX package's
``ops/reductions.py`` (the reference's Kahan summation,
``QuEST_cpu_distributed.c:87-109``): the ``calc*`` functions use these at
SINGLE precision, where a naive float32 reduction falls ~5 decades short of
the reference's 1e-10 scalar tolerance.

1. **TwoSum cascade** (:func:`sum_pair`): log2(n) halving levels; each level
   recovers the exact rounding error of every pairwise add into a
   correction stream.
2. **Veltkamp split products** (:func:`_split`, :func:`dot_pair`): a*b is
   four exactly representable partial products, so dot products accumulate
   true products, not rounded ones.
3. **Pair return**: the final (sum, err) pair comes back unadded and the
   API layer combines it in host double precision.

PyTorch runs eagerly, so where XLA fused the four product streams away
these functions would materialise them: :func:`dot_pair` walks its input
in chunks (``_CHUNK`` elements) and combines the chunk pairs with one more
TwoSum cascade. The pairing tree differs from the JAX package's; both are
error-free transformations, so the totals agree to the compensated
accuracy, not bit for bit.
"""

from __future__ import annotations

import torch

__all__ = ["sum_compensated", "sum_pair", "dot_pair", "vdot_pair",
           "vdot_compensated"]

# elements of each dot_pair input processed per step: the four product
# streams and the cascade's first level then take 6 * 2^24 values, a few
# hundred MiB at float32, whatever the register size
_CHUNK = 1 << 24


def _two_sum(a, b):
    """Knuth TwoSum: s = fl(a+b) and the exact rounding error e
    (a + b == s + e in exact arithmetic). Branch-free."""
    s = a + b
    b_virtual = s - a
    a_virtual = s - b_virtual
    e = (a - a_virtual) + (b - b_virtual)
    return s, e


def _split(x):
    """Veltkamp split: x == hi + lo with hi, lo each carrying at most half
    of the significand bits, so pairwise products of pieces are exact."""
    bits = 12 if x.dtype == torch.float32 else 27
    c = x * float((1 << bits) + 1)
    hi = c - (c - x)
    return hi, x - hi


def sum_pair(x):
    """Compensated sum of a real tensor; returns the unadded (sum, err)
    pair of 0-dim tensors so callers can combine at higher precision."""
    x = x.reshape(-1)
    err = torch.zeros((), dtype=x.dtype, device=x.device)
    while x.shape[0] > 1:
        if x.shape[0] % 2:
            x = torch.cat([x, x.new_zeros(1)])
        s, e = _two_sum(x[0::2], x[1::2])
        # the e's are O(eps)·|s| each; their naive sum contributes only a
        # second-order O(eps²·n) error to the final result
        err = err + e.sum()
        x = s
    return x[0], err


def sum_compensated(x) -> torch.Tensor:
    """Compensated sum of a real tensor."""
    s, e = sum_pair(x)
    return s + e


def _dot_pair_chunk(a, b):
    a_hi, a_lo = _split(a)
    b_hi, b_lo = _split(b)
    streams = torch.cat([a_hi * b_hi, a_hi * b_lo, a_lo * b_hi,
                         a_lo * b_lo])
    return sum_pair(streams)


def dot_pair(a, b):
    """sum(a*b) for real tensors with exact partial products: returns the
    (sum, err) pair."""
    a = a.reshape(-1)
    b = b.reshape(-1)
    sums, errs = [], []
    for lo in range(0, a.shape[0], _CHUNK):
        s, e = _dot_pair_chunk(a[lo:lo + _CHUNK], b[lo:lo + _CHUNK])
        sums.append(s)
        errs.append(e)
    if len(sums) == 1:
        return sums[0], errs[0]
    s, e = sum_pair(torch.stack(sums))
    return s, e + torch.stack(errs).sum()


def vdot_pair(a_planes, b_planes):
    """<a|b> for states given as (2, ...) re/im planes; returns
    ((re, re_err), (im, im_err))."""
    ar, ai = a_planes[0], a_planes[1]
    br, bi = b_planes[0], b_planes[1]
    re_s1, re_e1 = dot_pair(ar, br)
    re_s2, re_e2 = dot_pair(ai, bi)
    im_s1, im_e1 = dot_pair(ar, bi)
    im_s2, im_e2 = dot_pair(ai, br)
    re, re_c = _two_sum(re_s1, re_s2)
    im, im_c = _two_sum(im_s1, -im_s2)
    return (re, re_c + re_e1 + re_e2), (im, im_c + im_e1 - im_e2)


def vdot_compensated(a_planes, b_planes) -> complex:
    """<a|b> with compensated accumulation, combined in host double
    precision."""
    (re, re_e), (im, im_e) = vdot_pair(a_planes, b_planes)
    return complex(float(re) + float(re_e), float(im) + float(im_e))
