"""Exact top-1 nearest-neighbour search: the dispatcher and its three kernels.

The counterpart of ``e2eslam_tpu/ops/knn.py`` (which replaces the
reference's chamferdist CUDA KNN). For each query q the nearest valid ref
r minimises ``|q - r|^2``, i.e. maximises the score ``q.r - 0.5 |r|^2``:
queries are augmented as ``[q, 1]`` and refs as ``[r, -0.5 |r|^2]`` (refs
past ``nr`` carry the bias ``-1e30``), and the distance comes back as
``max(|q|^2 - 2 * best_score, 0)``. Indices are int32; entries past ``nq``
are undefined.

``knn`` is the dispatcher, plain torch on every device: padding, valid
counts, warm-seed re-scoring, the per-tile bounding boxes, the query Morton
sort, the candidate table, the choice of kernel and the unsort. Three
kernel wrappers do the search itself:

  * ``dense_kernel``    every ref tile, newest first;
  * ``cand_kernel``     the ref tiles a per-query-tile table lists;
  * ``resident_kernel`` refs of at most ``RES_MAX_ROWS`` rows in sub-tiles.

A wrapper launches its CUDA kernel (``ops/csrc/knn.cu``) for CUDA tensors
and runs its plain PyTorch version for CPU tensors; on a CUDA tensor it
launches or raises, it never falls back. Each wrapper counts its launches
in a plain integer attribute, ``launches``. The plain versions take the
same arguments and compute the same function; they visit tiles in the
kernels' order but do not prune (pruning never changes the result).

The tile constants are module attributes so that tests can shrink them.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from e2eslam_tpu_torch.ops.spatial_sort import morton_codes

Tensor = torch.Tensor

QT = 256  # query tile: one CUDA block, one query per thread
RT = 8192  # dense ref tile
RT_CAND = 2048  # candidate-table ref tile
MAX_CAND = 128  # candidate-table width (tiles per query tile)
RES_MAX_ROWS = 1 << 17  # largest ref set the resident kernel takes
ST = 2048  # resident sub-tile
NEG = -1e30  # bias of invalid refs
_MAX_SUBTILES = 1024  # resident sub-tiles a CUDA block can bound (knn.cu)

# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _seeds(q4: Tensor, s0: Optional[Tensor], i0: Optional[Tensor]):
    if s0 is None:
        return (torch.full((q4.shape[0],), NEG, dtype=torch.float32, device=q4.device),
                torch.zeros(q4.shape[0], dtype=torch.int32, device=q4.device))
    return s0.clone(), i0.clone()


def _take_better(best_s, best_i, tile_max, tile_arg):
    better = tile_max > best_s
    return torch.where(better, tile_max, best_s), torch.where(better, tile_arg, best_i)


def _tile_max(q4: Tensor, r4: Tensor, first: int, n: int):
    m, a = (q4 @ r4[first:first + n].T).max(dim=1)
    return m, (a + first).to(torch.int32)


def dense_plain(q4, r4, rbb, s0, i0, nq, nr, rt):
    """Running max over every valid ref tile, newest first."""
    best_s, best_i = _seeds(q4, s0, i0)
    for jr in range(r4.shape[0] // rt - 1, -1, -1):
        if jr * rt < nr:
            best_s, best_i = _take_better(best_s, best_i, *_tile_max(q4, r4, jr * rt, rt))
    return best_s, best_i


def cand_plain(q4, r4, rbb, s0, i0, cand, cnt, nq, nr, rt):
    """Running max over the tiles ``cand[i, :cnt[i]]`` of each query tile,
    in table order."""
    n_qt, mc = cand.shape
    qv = q4.view(n_qt, -1, 4)
    tiles = r4.view(-1, rt, 4)
    best_s, best_i = (t.view(n_qt, -1) for t in _seeds(q4, s0, i0))
    for j in range(min(int(cnt.max()), mc) if n_qt else 0):
        jr = cand[:, j].long()
        run = (j < cnt) & (jr * rt < nr)
        m, a = torch.bmm(qv, tiles[jr].transpose(1, 2)).max(dim=2)
        m = torch.where(run[:, None], m, torch.full_like(m, -float("inf")))
        a = (a + (jr * rt)[:, None]).to(torch.int32)
        best_s, best_i = _take_better(best_s, best_i, m, a)
    return best_s.reshape(-1), best_i.reshape(-1)


def _tile_boxes(pts: Tensor, tile: int) -> Tensor:
    """Per-tile bounding boxes ``[n_tiles, 8]``: min xyz, max xyz, 0, 0."""
    t = pts.reshape(-1, tile, pts.shape[-1])[..., :3]
    z = torch.zeros(t.shape[0], 2, dtype=pts.dtype, device=pts.device)
    return torch.cat([t.amin(dim=1), t.amax(dim=1), z], dim=1)


def _box_gap2(qbb: Tensor, rbb: Tensor) -> Tensor:
    """Squared gaps ``[n_qt, n_tiles]`` between query and ref boxes."""
    gap = torch.maximum(qbb[:, None, 0:3] - rbb[None, :, 3:6],
                        rbb[None, :, 0:3] - qbb[:, None, 3:6]).clamp(min=0.0)
    return (gap * gap).sum(dim=-1)


def resident_plain(q4, r4, rbb, s0, i0, nq, nr, st):
    """Each query tile visits its best sub-tile (least box gap) first, then
    the others in order."""
    S = r4.shape[0] // st
    lb = _box_gap2(_tile_boxes(q4, QT), rbb)
    valid_s = torch.arange(S, device=q4.device) * st < nr
    lb = torch.where(valid_s[None, :], lb, torch.full_like(lb, float("inf")))
    first = lb.argmin(dim=1).repeat_interleave(QT)  # per query
    maxes, args = zip(*(_tile_max(q4, r4, s * st, st) for s in range(S)))
    maxes, args = torch.stack(maxes, dim=1), torch.stack(args, dim=1)
    ninf = torch.full_like(maxes, -float("inf"))
    maxes = torch.where(valid_s[None, :], maxes, ninf)
    best_s, best_i = _seeds(q4, s0, i0)
    best_s, best_i = _take_better(best_s, best_i, maxes.gather(1, first[:, None])[:, 0],
                                  args.gather(1, first[:, None])[:, 0])
    for s in range(S):
        m = torch.where(first != s, maxes[:, s], ninf[:, s])
        best_s, best_i = _take_better(best_s, best_i, m, args[:, s])
    return best_s, best_i


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "knn_dense_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    "knn_cand_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    "knn_resident_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P],
}


def _fn(symbol: str):
    from e2eslam_tpu_torch.ops.cuda_build import load

    fn = getattr(load("knn"), symbol)
    fn.argtypes = _ARGTYPES[symbol]
    fn.restype = ctypes.c_int
    return fn


def _ptr(t: Optional[Tensor]):
    return None if t is None else t.data_ptr()


def _check(q4, r4, rbb, s0, i0, visits, tile, *extra):
    """Validate a kernel's arguments: device, type, contiguity, shapes."""
    dev = q4.device
    for name, t, dtype in (("q4", q4, torch.float32), ("r4", r4, torch.float32),
                           ("rbb", rbb, torch.float32), ("s0", s0, torch.float32),
                           ("i0", i0, torch.int32), ("visits", visits, torch.int32),
                           *extra):
        if t is None:
            continue
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous {dtype} tensor on {dev}, "
                             f"got {t.dtype} on {t.device}")
    if q4.ndim != 2 or q4.shape[1] != 4 or q4.shape[0] % QT:
        raise ValueError(f"q4 must be [n * {QT}, 4], got {tuple(q4.shape)}")
    if r4.ndim != 2 or r4.shape[1] != 4 or r4.shape[0] % tile:
        raise ValueError(f"r4 must be [n * {tile}, 4], got {tuple(r4.shape)}")
    if tuple(rbb.shape) != (r4.shape[0] // tile, 8):
        raise ValueError(f"rbb must be [{r4.shape[0] // tile}, 8], got {tuple(rbb.shape)}")
    if (s0 is None) != (i0 is None):
        raise ValueError("s0 and i0 come together")
    for name, t, n in (("s0", s0, q4.shape[0]), ("i0", i0, q4.shape[0]),
                       ("visits", visits, q4.shape[0] // QT)):
        if t is not None and tuple(t.shape) != (n,):
            raise ValueError(f"{name} must be [{n}], got {tuple(t.shape)}")
    if QT % 32 or QT > 1024:
        raise ValueError(f"QT={QT}: a CUDA block needs a multiple of 32 up to 1024")


def _launch(symbol: str, *args):
    stream = torch.cuda.current_stream().cuda_stream
    err = _fn(symbol)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{symbol} failed to launch: CUDA error {err}")


def _outputs(q4: Tensor):
    return (torch.empty(q4.shape[0], dtype=torch.float32, device=q4.device),
            torch.empty(q4.shape[0], dtype=torch.int32, device=q4.device))


class _Wrapper:
    """A kernel wrapper with its launch count (``launches``, a plain int
    raised by one where the CUDA kernel is launched, and nowhere else)."""

    def __init__(self, fn):
        self._fn = fn
        self.launches = 0
        self.__name__ = fn.__name__
        self.__doc__ = fn.__doc__

    def __call__(self, *args, **kwargs):
        return self._fn(self, *args, **kwargs)


@_Wrapper
def dense_kernel(self, q4, r4, rbb, s0, i0, nq: int, nr: int, rt: int, visits=None):
    """Replaces ``_dense_pallas_call``. ``q4 [n_qt*QT, 4]``, ``r4 [nrt*rt, 4]``,
    ``rbb [nrt, 8]``, seeds ``s0/i0 [n_qt*QT]`` or None. Returns the best
    score and index per query row. ``visits`` (optional int32 ``[n_qt]``,
    CUDA only) receives the ref rows each query tile visited."""
    if not q4.is_cuda:
        return dense_plain(q4, r4, rbb, s0, i0, nq, nr, rt)
    _check(q4, r4, rbb, s0, i0, visits, rt)
    out_s, out_i = _outputs(q4)
    _launch("knn_dense_launch", q4.data_ptr(), r4.data_ptr(), rbb.data_ptr(), _ptr(s0),
            _ptr(i0), q4.shape[0] // QT, QT, nq, nr, r4.shape[0] // rt, rt,
            out_s.data_ptr(), out_i.data_ptr(), _ptr(visits))
    self.launches += 1
    return out_s, out_i


@_Wrapper
def cand_kernel(self, q4, r4, rbb, s0, i0, cand, cnt, nq: int, nr: int, rt: int,
                visits=None):
    """Replaces ``_cand_pallas_call``. As ``dense_kernel``, plus the table
    ``cand [n_qt, MC]`` int32 (ref tiles in visit order) and ``cnt [n_qt]``
    int32 (entries used); seeds are required."""
    if not q4.is_cuda:
        return cand_plain(q4, r4, rbb, s0, i0, cand, cnt, nq, nr, rt)
    _check(q4, r4, rbb, s0, i0, visits, rt, ("cand", cand, torch.int32),
           ("cnt", cnt, torch.int32))
    if s0 is None or cand.shape[0] != q4.shape[0] // QT or cnt.shape != cand.shape[:1]:
        raise ValueError("cand_kernel needs seeds and a [n_qt, MC] table with [n_qt] counts")
    out_s, out_i = _outputs(q4)
    _launch("knn_cand_launch", q4.data_ptr(), r4.data_ptr(), rbb.data_ptr(), s0.data_ptr(),
            i0.data_ptr(), cand.data_ptr(), cnt.data_ptr(), cand.shape[1],
            q4.shape[0] // QT, QT, nq, nr, rt, out_s.data_ptr(), out_i.data_ptr(),
            _ptr(visits))
    self.launches += 1
    return out_s, out_i


@_Wrapper
def resident_kernel(self, q4, r4, rbb, s0, i0, nq: int, nr: int, st: int, visits=None):
    """Replaces ``_resident_pallas_call``. As ``dense_kernel`` with
    sub-tiles of ``st`` rows and their boxes ``rbb [S, 8]``."""
    if not q4.is_cuda:
        return resident_plain(q4, r4, rbb, s0, i0, nq, nr, st)
    _check(q4, r4, rbb, s0, i0, visits, st)
    S = r4.shape[0] // st
    if S > _MAX_SUBTILES:
        raise ValueError(f"resident_kernel takes at most {_MAX_SUBTILES} sub-tiles, got {S}")
    out_s, out_i = _outputs(q4)
    _launch("knn_resident_launch", q4.data_ptr(), r4.data_ptr(), rbb.data_ptr(), _ptr(s0),
            _ptr(i0), q4.shape[0] // QT, QT, nq, nr, S, st, out_s.data_ptr(),
            out_i.data_ptr(), _ptr(visits))
    self.launches += 1
    return out_s, out_i


KERNELS = (dense_kernel, cand_kernel, resident_kernel)


# ---------------------------------------------------------------------------
# the dispatcher
# ---------------------------------------------------------------------------


def _pad_rows(x: Tensor, n: int, value: float = 0.0) -> Tensor:
    if x.shape[0] >= n:
        return x
    pad = x.new_full((n - x.shape[0],) + tuple(x.shape[1:]), value)
    return torch.cat([x, pad], dim=0)


def knn(query: Tensor, ref: Tensor, nr=None, nq=None, init_idx=None,
        q_perm=None) -> Tuple[Tensor, Tensor]:
    """Top-1 KNN: for each query point, its nearest reference point.

    Args:
      query: ``[Nq, 3]``; ref: ``[Nr, 3]``.
      nr / nq: valid ref / query counts (python ints or 0-d tensors);
        default all. Refs past ``nr`` never match; results past ``nq`` are
        undefined.
      init_idx: optional ``[Nq]`` warm-start candidates (-1 or out of range
        = none). Each is re-scored at the current positions and seeds the
        search bound; the result is the true top-1 either way.
      q_perm: optional query permutation for the candidate-table path (any
        permutation is exact; results are unsorted at the end).

    Returns (squared distances ``[Nq]`` float32, indices ``[Nq]`` int32).
    """
    Nq, Nr = query.shape[0], ref.shape[0]
    if Nr == 0:
        raise ValueError("knn needs at least one reference row (nr may be 0)")
    nr = Nr if nr is None else int(nr)
    nq = Nq if nq is None else int(nq)
    dev = query.device
    nq_pad = -(-Nq // QT) * QT
    nr_pad = -(-Nr // RT) * RT
    q = query.float()

    # Candidate-table gate and query Morton sort (knn.py:340-386 of the JAX
    # package): sorted queries make each query tile spatially tight, so its
    # seeded threshold and candidate set stay small.
    rt_c = min(RT_CAND, RT)
    nrt_c = nr_pad // rt_c
    warm = init_idx is not None
    n_qt = nq_pad // QT
    if n_qt <= 2048:
        mc, sort_queries = MAX_CAND, True
    elif n_qt <= 16384:
        mc, sort_queries = 8, False
    else:
        mc, sort_queries = None, False
    use_cand = warm and mc is not None and nrt_c > mc
    qperm = None
    if use_cand and sort_queries:
        if q_perm is not None:
            qperm = q_perm.to(device=dev, dtype=torch.int64)
        else:
            codes = morton_codes(q, torch.arange(Nq, device=dev) < nq)
            qperm = torch.argsort(codes, stable=True)
        q = q[qperm]
        init_idx = init_idx[qperm]

    q4 = _pad_rows(torch.cat([q, q.new_ones(Nq, 1)], dim=1), nq_pad)
    r = ref.float()
    bias = -0.5 * (r * r).sum(dim=1)
    bias = torch.where(torch.arange(Nr, device=dev) < nr, bias, torch.full_like(bias, NEG))
    r4 = _pad_rows(torch.cat([r, bias[:, None]], dim=1), nr_pad)
    r4[Nr:, 3] = NEG
    r_pad = r4[:, :3]  # padded rows are zeros: they only widen a box

    s0 = i0 = None
    if warm:
        ii = init_idx.to(device=dev, dtype=torch.int64)
        ok = (ii >= 0) & (ii < nr)
        nn0 = r[ii.clamp(0, Nr - 1)]
        s0 = (q * nn0).sum(dim=1) - 0.5 * (nn0 * nn0).sum(dim=1)
        s0 = _pad_rows(torch.where(ok, s0, torch.full_like(s0, NEG)), nq_pad, NEG)
        i0 = _pad_rows(torch.where(ok, ii, torch.zeros_like(ii)).to(torch.int32), nq_pad)

    def fallback():
        # The resident kernel when the whole ref set is small, else dense.
        if nr_pad <= RES_MAX_ROWS and nr_pad % min(ST, RT) == 0:
            st = min(ST, RT)
            return resident_kernel(q4, r4, _tile_boxes(r_pad, st), s0, i0, nq, nr, st)
        return dense_kernel(q4, r4, _tile_boxes(r_pad, RT), s0, i0, nq, nr, RT)

    if use_cand:
        # Per query tile, every ref tile whose box gap is below the tile's
        # seeded worst-best distance, best first. The ulp guard admits
        # borderline tiles the kernel's own bound might still visit.
        q2p = (q4 * q4).sum(dim=1) - 1.0
        col = torch.arange(nq_pad, device=dev)
        d2_0 = torch.where(col < nq, q2p - 2.0 * s0, torch.full_like(q2p, -float("inf")))
        wb0 = d2_0.view(n_qt, QT).amax(dim=1)
        rbb_c = _tile_boxes(r_pad, rt_c)
        lb2 = _box_gap2(_tile_boxes(q4, QT), rbb_c)
        tile_valid = torch.arange(nrt_c, device=dev) * rt_c < nr
        lb2 = torch.where(tile_valid[None, :], lb2, torch.full_like(lb2, float("inf")))
        thresh = wb0 * (1.0 + 1e-6) + 1e-9
        is_cand = lb2 < thresh[:, None]
        counts = is_cand.sum(dim=1)
        # The JAX package chooses with lax.cond on the device; here it is a
        # host branch, one synchronisation per call.
        fits = int(counts.max()) <= mc
        if fits:
            order = torch.argsort(
                torch.where(is_cand, lb2, torch.full_like(lb2, float("inf"))),
                dim=1, stable=True)[:, :mc]
            cnt = counts.clamp(max=mc)
            last = order.gather(1, (cnt - 1).clamp(min=0)[:, None])
            jj = torch.arange(mc, device=dev)
            cand = torch.where(jj[None, :] < cnt.clamp(min=1)[:, None], order, last)
            best_s, best_i = cand_kernel(q4, r4, rbb_c, s0, i0, cand.to(torch.int32).contiguous(),
                                         cnt.to(torch.int32), nq, nr, rt_c)
        else:
            best_s, best_i = fallback()
    else:
        best_s, best_i = fallback()

    best_s, best_i = best_s[:Nq], best_i[:Nq]
    d2 = ((q * q).sum(dim=1) - 2.0 * best_s).clamp(min=0.0)
    if qperm is not None:
        # Row p of the sorted results belongs to query qperm[p].
        d2 = torch.empty_like(d2).index_put_((qperm,), d2)
        best_i = torch.empty_like(best_i).index_put_((qperm,), best_i)
    return d2, best_i
