"""Distributed NTT: the 4-step transform with its exchanges written out.

The counterpart of `aero_tpu/parallel/dist_ntt.py`. A size-n coefficient
(or evaluation) vector is sharded contiguously over the D ranks of a mesh;
with n = k1 * k2, input index i = i1 + k1*i2 and output index
o = o2 + k2*o1,

    out[o2 + k2*o1] =
        sum_i1 w1^(i1 o1) w_n^(i1 o2) sum_i2 w2^(i2 o2) x[i1 + k1*i2]

    1. all-to-all: gather i2 on each rank, split i1 across ranks
    2. local k2-point transforms along i2
    3. twiddle multiply by w_n^(i1*o2): each rank builds only its own
       (k1/D, k2) block of the table
    4. all-to-all: gather i1, split o2
    5. local k1-point transforms along i1
    6. all-to-all back to the natural contiguous sharding of the output

Three all-to-alls of n elements per transform. The local transforms are
the package's `ntt`/`intt` over a (batch * l, k) tensor: on a CUDA device
each is two launches of the `gl_colntt` kernel, on the CPU the plain
version. The reshapes and transposes follow the JAX module line by line
(`dist_ntt.py:96-114`); its radix-4 staging, its jit cache and its uniform
12-column chunks answer XLA's compile times and are not carried over.

Exact: the results equal the single-device `ntt`/`intt`/`lde` bit for bit.
"""

from __future__ import annotations

import functools

import torch

from ..field import from_u64, mul, power_series_rows
from ..ntt import intt, ntt
from ..ntt.tables import np_power_series
from ..spec import field as F
from .mesh import Mesh, send_to_rank, swap_blocks


def split_sizes(n: int, world: int):
    """(k1, k2, l1, l2) of a size-n transform over `world` ranks."""
    if n & (n - 1) or n < 1:
        raise ValueError(f"dist_ntt: size {n} is not a power of two")
    k1 = 1 << ((n.bit_length() - 1) // 2)
    k2 = n // k1
    if k1 % world or k2 % world:
        raise ValueError(f"dist_ntt: {world} ranks are too many for a "
                         f"size-{n} transform ({k1} x {k2})")
    return k1, k2, k1 // world, k2 // world


@functools.lru_cache(maxsize=32)
def _mid_twiddles(k1: int, k2: int, invert: bool, rank: int, world: int,
                  device: str) -> torch.Tensor:
    """This rank's block of the twiddle table between the two transforms:
    T[i1l, o2] = w_n^((rank * l1 + i1l) * o2), shape (k1 / world, k2)."""
    n = k1 * k2
    l1 = k1 // world
    w = F.get_root_of_unity(n.bit_length() - 1)
    if invert:
        w = F.inv(w)
    bases = np_power_series(w, l1, F.exp(w, rank * l1))     # w^i1, own rows
    return power_series_rows(from_u64(bases, device), k2)


def dist_ntt(mesh: Mesh, x: torch.Tensor, invert: bool = False
             ) -> torch.Tensor:
    """Size-n NTT (or iNTT) of a vector (..., n) whose last axis is sharded
    contiguously over the mesh: `x` is this rank's block (..., n / D), and
    so is the result, in natural order."""
    D = mesh.world
    batch = tuple(x.shape[:-1])
    n = x.shape[-1] * D
    k1, k2, l1, l2 = split_sizes(n, D)
    transform = intt if invert else ntt
    nb = x.numel() // x.shape[-1]
    tl = _mid_twiddles(k1, k2, invert, mesh.rank, D, str(x.device))

    # local view (b, l2, k1): [i2 local][i1], global index i1 + k1*i2
    # all-to-all 1: localize i2 (the axis of the inner transform), split i1
    b = swap_blocks(mesh, x.reshape(nb, l2, D, l1), "ntt")  # (b, D, l2, l1)
    b = b.reshape(nb, k2, l1)                               # [b][i2][i1l]
    a = transform(b.transpose(1, 2).contiguous())           # [b][i1l][o2]
    a = mul(a, tl)
    # all-to-all 2: localize i1 (the axis of the outer transform), split o2
    c = swap_blocks(mesh, a.reshape(nb, l1, D, l2), "ntt")  # (b, D, l1, l2)
    c = c.reshape(nb, k1, l2)                               # [b][i1][o2l]
    e = transform(c.transpose(1, 2).contiguous())           # [b][o2l][o1]
    # all-to-all 3: back to the natural contiguous sharding of the output
    f = swap_blocks(mesh, e.reshape(nb, l2, D, l1), "ntt")  # (b, D, l2, l1)
    f = f.reshape(nb, k2, l1)                               # [b][o2][o1l]
    # local flat index o1l*k2 + o2 is global out[o2 + k2*o1]
    return f.transpose(1, 2).reshape(batch + (l1 * k2,))


def pad_domain(mesh: Mesh, x: torch.Tensor, log_blowup: int) -> torch.Tensor:
    """Zero-extend a contiguously sharded vector (..., n) to (..., n << lb):
    the data must land at GLOBAL positions 0..n-1 and the zeros at n..m-1,
    so padding each block in place would interleave them. Rank s's block
    covers [s*n/D, (s+1)*n/D), which lies in block s >> lb of the padded
    vector; rank r therefore receives the blocks of ranks r*B .. r*B + B - 1
    (B = 2^lb, as far as they exist), in order, and fills up with zeros."""
    D, r = mesh.world, mesh.rank
    B = 1 << log_blowup
    sources = [s for s in range(r * B, min((r + 1) * B, D))]
    got = send_to_rank(mesh, x, r >> log_blowup, sources, "lde_pad")
    blk = x.shape[-1]
    out = torch.zeros(tuple(x.shape[:-1]) + (blk * B,), dtype=x.dtype,
                      device=x.device)
    for j in range(len(sources)):
        out[..., j * blk:(j + 1) * blk] = got[j]
    return out


def dist_lde_coeffs(mesh: Mesh, polys: torch.Tensor, log_blowup: int,
                    offset: int = F.DOMAIN_OFFSET) -> torch.Tensor:
    """Coset LDE of sharded coefficient rows (..., n / D): scale by
    offset^i, zero-extend to m = n << log_blowup, distributed NTT. Returns
    this rank's block (..., m / D) of the evaluations over offset * <w_m>."""
    blk = polys.shape[-1]
    first = F.exp(offset, mesh.rank * blk)              # offset^(r * n / D)
    sc = from_u64(np_power_series(offset, blk, first), polys.device)
    return dist_ntt(mesh, pad_domain(mesh, mul(polys, sc), log_blowup))


def dist_lde(mesh: Mesh, evals: torch.Tensor, log_blowup: int,
             offset: int = F.DOMAIN_OFFSET) -> torch.Tensor:
    """Distributed trace extension of sharded evaluations (..., n / D):
    iNTT, then `dist_lde_coeffs`."""
    return dist_lde_coeffs(mesh, dist_ntt(mesh, evals, invert=True),
                           log_blowup, offset)
