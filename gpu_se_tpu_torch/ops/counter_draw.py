"""Counter-based noise: Philox4x32-10 through a hand-written CUDA kernel.

Sample ``j`` of a draw depends only on a key and on ``j``, so a rank of
the sharded steps draws only the samples of its own slice, and any split
of ``[0, n)`` into slices concatenates to the whole draw: the port's
counterpart of the reference's partitionable threefry, which makes each
device draw only its slice under a sharded jit
(``gpu_se_tpu/parallel/sharded.py:1015-1017``, ``:1133-1135``). The
streams differ: compare distributions, or feed both packages the same
normals (``GaussianSum.draw_from``).

Sample ``j`` takes the Philox4x32-10 blocks (Salmon et al., SC 2011) of
the counters ``(j mod 2^32, j div 2^32, b, 0)`` under the key ``(k0,
k1)``, ``b = 0 .. nb - 1``, four 32-bit words each, in order ``w_0, w_1,
...``: the uniform ``u = (w_0 >> 8) 2^-24``, exact in float32, and the
normals by Box–Muller, ``u1 = ((w_{1+2q} >> 8) + 1) 2^-24``, ``u2 =
(w_{2+2q} >> 8) 2^-24``, ``z_{2q} = sqrt(-2 log u1) cos(2 pi u2)``,
``z_{2q+1} = sqrt(-2 log u1) sin(2 pi u2)``, in float32, the last sine
dropped for an odd ``nx``.

:func:`counter_draw` (``csrc/counter_draw.cu``) launches the kernel for
a CUDA key and takes :func:`counter_draw_plain` (torch int64 ops, the
32-bit products split into 16-bit halves) for a CPU one; there is no
fallback from one to the other. ``counter_draw.launches`` counts
launches (an empty draw launches nothing). The two give the same words bit for bit and the same
uniforms; the normals go through the CUDA and the CPU ``log``, ``sqrt``,
``sin`` and ``cos`` of float32, which part by an ulp or two:
:data:`NORMAL_ATOL` bounds them.
"""
from __future__ import annotations

import math

import torch

from gpu_se_tpu_torch.ops import _build

M0, M1 = 0xD2511F53, 0xCD9E8D57      # the round multipliers
W0, W1 = 0x9E3779B9, 0xBB67AE85      # the key's Weyl increments
ROUNDS = 10
MASK32 = 0xFFFFFFFF
TWO_PI = 6.28318530717958647692      # rounded to float32 before use
# |kernel - plain| of a normal: |z| < 5.8 (u1 >= 2^-24); the card's logf
# (1 ulp), sqrtf (correctly rounded) and sincosf (2 ulp) and the CPU's
# float32 log, sqrt and sin/cos (each within an ulp or two) keep the two
# within a few float32 ulp of 5.8 (4.8e-7 each)
NORMAL_ATOL = 8e-6


def blocks_of(nx: int) -> int:
    """The Philox blocks a sample takes: one word for its uniform, two a
    pair of normals."""
    return (2 * ((nx + 1) // 2) + 4) // 4


def key_from(generator: torch.Generator, device) -> torch.Tensor:
    """A step's key, ``(2,)`` int64 in ``[0, 2^32)`` on ``device``, drawn
    from ``generator`` (no host read): every rank whose generator is in
    the same state takes the same key, and the generator advances by the
    same amount."""
    return torch.randint(0, 2**32, (2,), dtype=torch.int64,
                         generator=generator, device=device)


def _mulhilo(m: int, a: torch.Tensor):
    """``(hi, lo)`` 32-bit words of ``m * a`` for ``a`` in ``[0, 2^32)``
    (int64), exact: each product of ``m`` with a 16-bit half stays below
    2^48."""
    p_lo = m * (a & 0xFFFF)
    p_hi = m * (a >> 16)
    t = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (t >> 32), t & MASK32


def philox_plain(counters, k0: torch.Tensor, k1: torch.Tensor):
    """Philox4x32-10 of the four int64 counter words ``counters`` (each in
    ``[0, 2^32)``, broadcastable) under the key ``(k0, k1)``; returns the
    four output words, int64 in ``[0, 2^32)``."""
    c0, c1, c2, c3 = counters
    for rnd in range(ROUNDS):
        if rnd:
            k0 = (k0 + W0) & MASK32
            k1 = (k1 + W1) & MASK32
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def words_plain(key: torch.Tensor, start: int, count: int,
                nx: int) -> torch.Tensor:
    """The ``(count, 4 blocks_of(nx))`` int64 Philox words of the samples
    ``[start, start + count)``."""
    dev = key.device
    j = torch.arange(start, start + count, dtype=torch.int64, device=dev)
    k0, k1 = key[0] & MASK32, key[1] & MASK32
    zero = torch.zeros_like(j)
    out = []
    for b in range(blocks_of(nx)):
        out.extend(philox_plain((j & MASK32, j >> 32, zero + b, zero),
                                k0, k1))
    return torch.stack(out, dim=1)


def _unit(w: torch.Tensor, plus: int = 0) -> torch.Tensor:
    """``((w >> 8) + plus) 2^-24`` in float32, exact."""
    return ((w >> 8) + plus).to(torch.float32) * (1.0 / 16777216.0)


def floats_from_words(words: torch.Tensor, nx: int):
    """``(eps (count, nx), u (count,))`` float32 of the words, as the
    kernel computes them."""
    u = _unit(words[:, 0])
    two_pi = torch.tensor(TWO_PI, dtype=torch.float32)
    cols = []
    for q in range(0, nx, 2):
        u1 = _unit(words[:, 1 + q], 1)
        u2 = _unit(words[:, 2 + q])
        radius = torch.sqrt(-2.0 * torch.log(u1))
        angle = two_pi.to(u2.device) * u2
        cols.append(radius * torch.cos(angle))
        if q + 1 < nx:
            cols.append(radius * torch.sin(angle))
    return torch.stack(cols, dim=1), u


def counter_draw_plain(key: torch.Tensor, start: int, count: int, nx: int,
                       lanes_last: bool = False, words: bool = False):
    """Plain version of :func:`counter_draw`."""
    w = words_plain(key, start, count, nx)
    eps, u = floats_from_words(w, nx)
    eps = eps.T.contiguous() if lanes_last else eps
    return (eps, u, w) if words else (eps, u)


def counter_draw(key: torch.Tensor, start: int, count: int, nx: int,
                 lanes_last: bool = False, words: bool = False):
    """``nx`` standard normals and one uniform in ``[0, 1)`` for each of
    the samples ``[start, start + count)`` of the stream keyed by ``key``
    (``(2,)`` int64, the low 32 bits of each entry the Philox key).

    Returns ``(eps, u)``: ``eps`` float32 ``(count, nx)``, or ``(nx,
    count)`` where ``lanes_last``, and ``u`` float32 ``(count,)``, on the
    key's device. With ``words``, also the ``(count, 4 blocks_of(nx))``
    Philox words (int64 from the plain version, int32 holding the same
    bits from the kernel): a verification hook, kept so that the tests
    and the smoke run hold the kernel's integer stream to the plain
    version's bit for bit, apart from the float transforms. No step
    asks for it.
    """
    dev = key.device
    _build.check("key", key, torch.int64, 1, dev)
    if key.shape[0] != 2:
        raise ValueError(f"key {tuple(key.shape)}: expected (2,)")
    start, count, nx = int(start), int(count), int(nx)
    if start < 0 or count < 0 or nx < 1 or start + count > 2**63 - 1 \
            or count > 2**31 - 1:
        raise ValueError(f"start {start}, count {count}, nx {nx}")
    if not _build.on_cuda(key):
        return counter_draw_plain(key, start, count, nx, lanes_last, words)
    lib = _build.load_library()
    shape = (nx, count) if lanes_last else (count, nx)
    eps = torch.empty(shape, dtype=torch.float32, device=dev)
    u = torch.empty((count,), dtype=torch.float32, device=dev)
    w = (torch.empty((count, 4 * blocks_of(nx)), dtype=torch.int32,
                     device=dev) if words else None)
    with torch.cuda.device(dev):
        rc = lib.gst_counter_draw(
            key.data_ptr(), start, count, nx, int(lanes_last),
            None if w is None else w.data_ptr(), eps.data_ptr(),
            u.data_ptr(), _build.stream(dev))
    _build.launch_check("counter_draw", rc)
    if count:
        counter_draw.launches += 1
    return (eps, u, w) if words else (eps, u)


counter_draw.launches = 0


def draw_bytes(count: int, nx: int) -> int:
    """Bytes :func:`counter_draw` must move: the 16-byte key read, the
    normals and uniforms written."""
    return 16 + 4 * count * (nx + 1)


def draw_ops(count: int, nx: int) -> float:
    """Float32 operations of the Box–Muller transform a draw makes: the
    uniform's convert and scale, and a pair's two converts, two scales,
    ``log``, ``-2 *``, ``sqrt``, the angle, ``sin``, ``cos`` and two
    products (each function counted as one). The integer Philox rounds
    have no row in the card's table of peaks."""
    return count * (2 + 12 * math.ceil(nx / 2))
