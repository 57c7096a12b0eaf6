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
(`dist_ntt.py:96-114`); its radix-4 staging and its jit cache answer XLA's
compile times and are not carried over.

The LDE runs in chunks of rows, as `aero_tpu/parallel/sharded.py:230-280`
does (`chunk_cols` states the width; every rank of a mesh takes the same,
`lde_chunk_cols`), so that what a transform copies, pads and exchanges
scales with the chunk and not with the trace's width; each chunk's result
is written into one output allocated once. Unlike the JAX module, a chunk
is not padded to a uniform width: the last is simply narrower.

Exact: the results equal the single-device `ntt`/`intt`/`lde` bit for bit,
at every chunk width.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from ..field import from_u64, mul, power_series_rows
from ..ntt import intt, ntt
from ..ntt.tables import np_power_series
from ..spec import field as F
from .mesh import Mesh, all_gather, send_to_rank, swap_blocks


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


def dist_ntt(mesh: Mesh, x: torch.Tensor, invert: bool = False,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Size-n NTT (or iNTT) of a vector (..., n) whose last axis is sharded
    contiguously over the mesh: `x` is this rank's block (..., n / D), and
    so is the result, in natural order, written into `out` (of x's shape)
    when one is given.

    Each step drops its input before the next allocates, so that at most
    three blocks of x's size are alive at once (besides `x`, which the
    caller may hold: a temporary passed in is freed after the first
    exchange)."""
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
    del x
    b = b.reshape(nb, k2, l1).transpose(1, 2).contiguous()  # [b][i1l][i2]
    a = transform(b)                                        # [b][i1l][o2]
    del b
    a = mul(a, tl)
    # all-to-all 2: localize i1 (the axis of the outer transform), split o2
    c = swap_blocks(mesh, a.reshape(nb, l1, D, l2), "ntt")  # (b, D, l1, l2)
    del a
    c = c.reshape(nb, k1, l2).transpose(1, 2).contiguous()  # [b][o2l][i1]
    e = transform(c)                                        # [b][o2l][o1]
    del c
    # all-to-all 3: back to the natural contiguous sharding of the output
    f = swap_blocks(mesh, e.reshape(nb, l2, D, l1), "ntt")  # (b, D, l2, l1)
    del e
    # local flat index o1l*k2 + o2 is global out[o2 + k2*o1]
    f = f.reshape(nb, k2, l1).transpose(1, 2)               # [b][o1l][o2]
    if out is None:
        return f.reshape(batch + (l1 * k2,))
    out.view(nb, l1, k2).copy_(f)
    return out


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


CHUNK_COLS = 12     # aero_tpu's chunk width (aero_tpu/parallel/sharded.py:238)


def chunk_bytes(rows: int, n_blk: int, m_blk: int) -> int:
    """The most device memory one LDE chunk of `rows` rows holds besides
    its output, in bytes: three (rows, m / D) blocks (a transform's input,
    middle and output; an exchange's input, copy and output) and two
    (rows, n / D) blocks (the scaled coefficients and those received)."""
    return 8 * rows * (3 * m_blk + 2 * n_blk)


def chunk_cols(width: int, n_blk: int, m_blk: int,
               free_bytes: Optional[int]) -> int:
    """How many rows of a (width, n / D) block an LDE to (width, m / D)
    takes at a time: CHUNK_COLS (12, aero_tpu's width), fewer where
    `chunk_bytes` of that many rows would exceed a quarter of the device
    memory that is free, never fewer than 1 and never more than `width`.
    `free_bytes` None (the CPU, whose memory is not asked): all `width`
    rows at once."""
    if free_bytes is None:
        return width
    fit = free_bytes // (4 * chunk_bytes(1, n_blk, m_blk))
    return max(1, min(width, CHUNK_COLS, fit))


def least_free_bytes(mesh: Mesh, free_bytes: int) -> int:
    """The least of every rank's `free_bytes` (one all-gather of a
    scalar), so that ranks that share a card, or hold cards of unequal
    load, agree on one chunk width and so make the same exchanges."""
    mine = torch.tensor([free_bytes], dtype=torch.int64, device=mesh.device)
    return int(all_gather(mesh, mine, "free_bytes").min())


def lde_chunk_cols(mesh: Mesh, width: int, n_blk: int, m_blk: int) -> int:
    """`chunk_cols` of an LDE of (width, n / D) rows on this mesh: with
    the least device memory any rank has free (`least_free_bytes`); all
    `width` rows on the CPU."""
    free = None
    if mesh.device.type == "cuda":
        free = least_free_bytes(mesh, torch.cuda.mem_get_info(mesh.device)[0])
    return chunk_cols(width, n_blk, m_blk, free)


def _chunked_lde(mesh: Mesh, x: torch.Tensor, log_blowup: int, offset: int,
                 from_evals: bool, cols_per_chunk: Optional[int],
                 coeffs: Optional[torch.Tensor]) -> torch.Tensor:
    """The coset LDE of sharded rows (..., n / D), evaluations (iNTT first)
    or coefficients, `cols_per_chunk` rows at a time (None:
    `lde_chunk_cols`, all rows on the CPU): scale by offset^i,
    zero-extend, distributed NTT, into one output (..., m / D); `coeffs`,
    if given, receives the coefficients of evaluations."""
    blk = x.shape[-1]
    m_blk = blk << log_blowup
    rows = x.reshape(-1, blk)
    if cols_per_chunk is None:
        cols_per_chunk = lde_chunk_cols(mesh, rows.shape[0], blk, m_blk)
    elif cols_per_chunk < 1:
        raise ValueError(f"cols_per_chunk must be positive, got "
                         f"{cols_per_chunk}")
    c = min(rows.shape[0], cols_per_chunk)
    out = torch.empty(tuple(x.shape[:-1]) + (m_blk,), dtype=torch.int64,
                      device=x.device)
    flat = out.view(-1, m_blk)
    flat_coeffs = None if coeffs is None else coeffs.view(-1, blk)
    first = F.exp(offset, mesh.rank * blk)              # offset^(r * n / D)
    sc = from_u64(np_power_series(offset, blk, first), x.device)
    for a in range(0, rows.shape[0], c):
        sl = slice(a, a + c)
        p = rows[sl]
        if from_evals:
            p = dist_ntt(mesh, p, invert=True,
                         out=None if flat_coeffs is None else flat_coeffs[sl])
        dist_ntt(mesh, pad_domain(mesh, mul(p, sc), log_blowup),
                 out=flat[sl])
    return out


def dist_lde_coeffs(mesh: Mesh, polys: torch.Tensor, log_blowup: int,
                    offset: int = F.DOMAIN_OFFSET,
                    cols_per_chunk: Optional[int] = None) -> torch.Tensor:
    """Coset LDE of sharded coefficient rows (..., n / D): scale by
    offset^i, zero-extend to m = n << log_blowup, distributed NTT, one
    chunk of `cols_per_chunk` rows at a time (None: `lde_chunk_cols`).
    Returns this rank's block (..., m / D) of the evaluations over
    offset * <w_m>, allocated once."""
    return _chunked_lde(mesh, polys, log_blowup, offset, False,
                        cols_per_chunk, None)


def dist_lde(mesh: Mesh, evals: torch.Tensor, log_blowup: int,
             offset: int = F.DOMAIN_OFFSET,
             cols_per_chunk: Optional[int] = None,
             coeffs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Distributed trace extension of sharded evaluations (..., n / D):
    iNTT, then as `dist_lde_coeffs`, chunk by chunk. `coeffs` (evals'
    shape), if given, receives the coefficients."""
    return _chunked_lde(mesh, evals, log_blowup, offset, True,
                        cols_per_chunk, coeffs)
