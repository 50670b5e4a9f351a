"""The exploration noise of random sampling, drawn as the sampling kernels draw it.

Plain torch twin of Philox4x32-10 (Salmon et al., SC'11) with the counter (sample i,
chunk k, offset low word, offset high word) and the key (seed low word, seed high
word), Box-Muller on the top 24 bits of each word, and the three bands of random
sampling: sample 0 is the incumbent (no noise), samples [1, band1) ~ N(0, s1),
[band1, band2) ~ N(0, s2), the rest ~ U[-s3, s3), with band1 = 1 + N // 3 and
band2 = 1 + 2 (N // 3). A leg's PL parameters are ceil(PL / 4) chunks of four words.

Unsigned 32-bit arithmetic runs in int64 tensors, and the 32 x 32-bit products are
split into 16-bit halves so that nothing overflows. The normals are rounded to
float32 from float64 logarithms, sines and cosines, so they lie within an ulp or
two of the card's ``logf`` and ``sincospif``; the uniform band is exact.
"""
from __future__ import annotations

import math

import torch

M32 = 0xFFFFFFFF
_MUL0, _MUL1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85


def _mulhilo(a: int, b: torch.Tensor):
    """(high, low) 32-bit words of the 64-bit product of the constant ``a`` and
    ``b`` (int64 tensor of values below 2**32)."""
    a_hi, a_lo = a >> 16, a & 0xFFFF
    lo_part = b * a_lo
    hi_part = b * a_hi
    t = ((hi_part & 0xFFFF) << 16) + lo_part
    return (hi_part >> 16) + (t >> 32), t & M32


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Ten Philox rounds of the counter words c0..c3 under the key (k0, k1); int64
    tensors (or ints) holding unsigned 32-bit words, broadcast together."""
    for r in range(10):
        if r > 0:
            k0 = (k0 + _W0) & M32
            k1 = (k1 + _W1) & M32
        hi0, lo0 = _mulhilo(_MUL0, c0)
        hi1, lo1 = _mulhilo(_MUL1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _u01(x: torch.Tensor) -> torch.Tensor:
    """Uniform in [0, 1) from the top 24 bits of a word, exact in float32."""
    return (x >> 8).to(torch.float32) * (1.0 / 16777216.0)


def _box_muller(a, b):
    u1 = 1.0 - _u01(a)  # (0, 1]: exact in float32
    u2 = _u01(b)
    lg = torch.log(u1.to(torch.float64)).to(torch.float32)
    r = torch.sqrt(-2.0 * lg)
    ang = (2.0 * u2).to(torch.float64) * math.pi
    c = torch.cos(ang).to(torch.float32)
    s = torch.sin(ang).to(torch.float32)
    return r * c, r * s


def band_edges(num_samples: int) -> tuple:
    n3 = num_samples // 3
    return 1 + n3, 1 + 2 * n3


def random_sampling_noise(seeds: torch.Tensor, offsets: torch.Tensor, params_per_leg: int,
                          num_samples: int, sigmas: tuple) -> torch.Tensor:
    """(S, 4 * PL, N) float32 noise of one random-sampling iteration of S scenarios,
    scenario s keyed on (seeds[s], offsets[s]) (int64 tensors on the device the
    noise is made on)."""
    dev = seeds.device
    S, PL, N = seeds.shape[0], params_per_leg, num_samples
    ch = (PL + 3) // 4  # chunks of one leg
    s1, s2, s3 = (float(s) for s in sigmas)
    b1, b2 = band_edges(N)
    seed = seeds.to(torch.int64)
    off = offsets.to(torch.int64)
    k0 = (seed & M32)[:, None, None]
    k1 = ((seed >> 32) & M32)[:, None, None]
    c2 = (off & M32)[:, None, None]
    c3 = ((off >> 32) & M32)[:, None, None]
    i = torch.arange(N, dtype=torch.int64, device=dev)[None, None, :]
    k = torch.arange(4 * ch, dtype=torch.int64, device=dev)[None, :, None]
    w = philox4x32_10(i, k, c2, c3, k0, k1)  # 4 x (S, 4 ch, N)
    z01 = _box_muller(w[0], w[1])
    z23 = _box_muller(w[2], w[3])
    normal = torch.stack([z01[0], z01[1], z23[0], z23[1]], dim=2)  # (S, 4 ch, 4, N)
    width = 2.0 * s3
    uniform = torch.stack([-s3 + width * _u01(x) for x in w], dim=2)
    idx = torch.arange(N, device=dev)
    scale = torch.where(idx < b1, s1, s2).to(torch.float32)
    noise = torch.where(idx >= b2, uniform, normal * scale)
    noise[..., 0] = 0.0
    noise = noise.reshape(S, 4, ch * 4, N)[:, :, :PL, :]
    return noise.reshape(S, 4 * PL, N).contiguous()
