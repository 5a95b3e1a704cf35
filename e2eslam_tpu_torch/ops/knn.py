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

  * ``dense_kernel``    every valid ref tile, newest first;
  * ``cand_kernel``     the ref tiles a per-query-tile table lists;
  * ``resident_kernel`` refs of at most ``RES_MAX_ROWS`` rows in sub-tiles,
    each query tile's best sub-tile first, then the others in order.

A wrapper launches its CUDA kernel (``ops/csrc/knn.cu``) for CUDA tensors
and runs its plain PyTorch version for CPU tensors; on a CUDA tensor it
launches or raises, it never falls back. Each wrapper counts its launches
in a plain integer attribute, ``launches``. The plain versions take the
same arguments and compute the same function; they visit tiles in the
kernels' order but do not prune (pruning never changes the result). The
three kernels share one core that walks a list of tiles per query tile;
they split a long list over several work items and merge the shares:
``cand_split_plain`` and ``resident_split_plain`` are the plain versions
of that rule, and ``resident_table`` writes the resident order as a list.

The tile constants are module attributes so that tests can shrink them.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from e2eslam_tpu_torch.ops.spatial_sort import morton_codes

Tensor = torch.Tensor

QT = 256  # query tile: a table row, the rows whose box picks a resident list's first sub-tile
RT = 2048  # dense ref tile
RT_CAND = 2048  # candidate-table ref tile
MAX_TABLE_TILES = 2048  # most query tiles a warm call takes the candidate table for
RES_MAX_ROWS = 1 << 17  # largest ref set the resident kernel takes
ST = 2048  # resident sub-tile
NEG = -1e30  # bias of invalid refs
SPLIT_MIN = 2  # list entries per work item of the dense and candidate kernels, at least
MAX_SPLITS = 32  # work items a query group's list is split into, at most
# The same two for the resident kernel (RES_MAX_SPLITS <= MAX_SPLITS): every
# share of its list also walks the best sub-tile, so it splits less.
RES_SPLIT_MIN = 8
RES_MAX_SPLITS = 4

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


def _table_walk(q4, r4, s0, i0, cand, cnt, nr, rt):
    """Running max over the tiles ``cand[i, :cnt[i]]`` of each query tile,
    in table order; also the table column of each winner (-1: the seed)."""
    n_qt, mc = cand.shape
    qv = q4.view(n_qt, -1, 4)
    tiles = r4.view(-1, rt, 4)
    best_s, best_i = (t.view(n_qt, -1) for t in _seeds(q4, s0, i0))
    best_p = torch.full_like(best_i, -1)
    for j in range(min(int(cnt.max()), mc) if n_qt else 0):
        # Entries naming no valid tile are skipped, as the kernels skip them.
        jr = cand[:, j].long()
        run = (j < cnt) & (jr >= 0) & (jr < tiles.shape[0]) & (jr * rt < nr)
        jr = jr.clamp(0, tiles.shape[0] - 1)
        m, a = torch.bmm(qv, tiles[jr].transpose(1, 2)).max(dim=2)
        m = torch.where(run[:, None], m, torch.full_like(m, -float("inf")))
        a = (a + (jr * rt)[:, None]).to(torch.int32)
        best_p = torch.where(m > best_s, j, best_p)
        best_s, best_i = _take_better(best_s, best_i, m, a)
    return best_s.reshape(-1), best_i.reshape(-1), best_p.reshape(-1)


def cand_plain(q4, r4, rbb, s0, i0, cand, cnt, nq, nr, rt):
    """Running max over the tiles ``cand[i, :cnt[i]]`` of each query tile,
    in table order."""
    return _table_walk(q4, r4, s0, i0, cand, cnt, nr, rt)[:2]


def cand_split_plain(q4, r4, rbb, s0, i0, cand, cnt, nq, nr, rt, splits: int):
    """The candidate kernel's split and merge, in plain torch: split ``s``
    walks table positions ``s, s + splits, ...`` from the seed; the merge
    takes the higher score, then the lower table position (the seed is
    position -1). Equal to ``cand_plain`` (the sequential walk)."""
    parts = []
    for s in range(splits):
        n = ((cnt - s).clamp(min=0) + splits - 1) // splits
        sc, ix, p = _table_walk(q4, r4, s0, i0, cand[:, s::splits].contiguous(), n, nr, rt)
        parts.append((sc, ix, torch.where(p >= 0, s + p * splits, p)))
    return _merge(parts)


def _merge(parts):
    """Merge the shares' (score, index, list position) results: the higher
    score, then the lower position (the seed is position -1)."""
    best_s, best_i, best_p = parts[0]
    for sc, ix, p in parts[1:]:
        take = (sc > best_s) | ((sc == best_s) & (p < best_p))
        best_s, best_i = torch.where(take, sc, best_s), torch.where(take, ix, best_i)
        best_p = torch.where(take, p, best_p)
    return best_s, best_i


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


def _subtile_boxes(rbb: Tensor, S: int) -> Tensor:
    """The boxes ``[S, 6]`` of S sub-tiles, from ``rbb`` holding one box per
    sub-tile or several (the sub-tile's box is their union, exactly)."""
    b = rbb.reshape(S, -1, rbb.shape[-1])
    return torch.cat([b[:, :, 0:3].amin(dim=1), b[:, :, 3:6].amax(dim=1)], dim=1)


def resident_plain(q4, r4, rbb, s0, i0, nq, nr, st):
    """Each query tile visits its best sub-tile (least box gap, the lowest
    index on ties) first, then the others in order. ``rbb`` holds one box
    per sub-tile of ``st`` rows, or one per equal part of a sub-tile."""
    S = r4.shape[0] // st
    lb = _box_gap2(_tile_boxes(q4, QT), _subtile_boxes(rbb, S))
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


def resident_table(q4, r4, rbb, nr, st):
    """The resident kernel's list as a candidate table: per query tile the
    valid sub-tiles, the one of least box gap first (the lowest index on
    ties), then the others ascending. Returns ``cand [n_qt, n]`` and
    ``cnt [n_qt]`` (int32), ``n`` the valid sub-tiles."""
    n_qt, S = q4.shape[0] // QT, r4.shape[0] // st
    n = min(S, -(-nr // st))
    first = torch.zeros(n_qt, 1, dtype=torch.int64, device=q4.device)
    if n:
        lb = _box_gap2(_tile_boxes(q4, QT), _subtile_boxes(rbb, S)[:n])
        first = lb.argmin(dim=1, keepdim=True)
    rest = torch.arange(max(n - 1, 0), device=q4.device).expand(n_qt, -1)
    cand = torch.cat([first, rest + (rest >= first).long()], dim=1)[:, :n]
    return cand.to(torch.int32), torch.full((n_qt,), n, dtype=torch.int32, device=q4.device)


def resident_split_plain(q4, r4, rbb, s0, i0, nq, nr, st, splits: int):
    """The resident kernel's split and merge, in plain torch: share ``s``
    walks list position 0 (the best sub-tile) from the seed, then positions
    ``1 + s, 1 + s + splits, ...``; the merge takes the higher score, then
    the lower list position. Equal to ``resident_plain``."""
    cand, _ = resident_table(q4, r4, rbb, nr, st)
    if not cand.shape[1]:
        return _seeds(q4, s0, i0)
    parts = []
    for s in range(splits):
        cols = torch.tensor([0, *range(1 + s, cand.shape[1], splits)][:cand.shape[1]],
                            dtype=torch.int64, device=q4.device)
        cnt = torch.full((cand.shape[0],), cols.numel(), dtype=torch.int32, device=q4.device)
        sc, ix, p = _table_walk(q4, r4, s0, i0, cand[:, cols].contiguous(), cnt, nr, st)
        parts.append((sc, ix, torch.where(p >= 0, cols[p.clamp(min=0)], p)))
    return _merge(parts)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "knn_dense_launch": [_P] * 5 + [_I] * 8 + [_P] * 7,
    "knn_cand_launch": [_P] * 8 + [_I] * 9 + [_P] * 7,
    "knn_resident_launch": [_P] * 5 + [_I] * 8 + [_P] * 7,
    "knn_walk_config": [ctypes.POINTER(_I)],
}


def _fn(symbol: str):
    from e2eslam_tpu_torch.ops.cuda_build import load

    fn = getattr(load("knn"), symbol)
    fn.argtypes = _ARGTYPES[symbol]
    fn.restype = ctypes.c_int
    return fn


def _ptr(t: Optional[Tensor]):
    return None if t is None else t.data_ptr()


def _check(q4, r4, rbb, s0, i0, visits, tile, *extra, box=None):
    """Validate a kernel's arguments: device, type, contiguity, shapes
    (``rbb``: one box per ``box`` ref rows, default ``tile``)."""
    dev = q4.device
    box = box or tile
    for name, t, dtype in (("q4", q4, torch.float32), ("r4", r4, torch.float32),
                           ("rbb", rbb, torch.float32), ("s0", s0, torch.float32),
                           ("i0", i0, torch.int32), ("visits", visits, torch.int64),
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
    if tuple(rbb.shape) != (r4.shape[0] // box, 8):
        raise ValueError(f"rbb must be [{r4.shape[0] // box}, 8], got {tuple(rbb.shape)}")
    if (s0 is None) != (i0 is None):
        raise ValueError("s0 and i0 come together")
    for name, t, n in (("s0", s0, q4.shape[0]), ("i0", i0, q4.shape[0])):
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


_WALK_CONFIG = {}


def walk_config() -> dict:
    """The kernels' compile-time shape, read from the built library
    (``knn.cu`` owns it): ``qpt`` queries per thread, ``chunk`` ref rows
    staged at a time, ``group`` rows per running max."""
    if not _WALK_CONFIG:
        out = (_I * 3)()
        _fn("knn_walk_config")(out)
        _WALK_CONFIG.update(qpt=out[0], chunk=out[1], group=out[2])
    return _WALK_CONFIG


def walk_items_max(n_qt: int) -> int:
    """The most work items of a kernel call: one per query group
    (``32 * qpt`` queries, one warp) and share of its list."""
    return n_qt * (QT // (32 * walk_config()["qpt"])) * MAX_SPLITS


def fp32_distance_bound(q: Tensor, r: Tensor) -> Tensor:
    """How far two float32 evaluations of ``|q - r|^2`` may differ, per row,
    for the kernels' and plain versions' arithmetic (``q``, ``r`` float64
    ``[n, 3]``, ``r`` the row either picked). A score ``q.r - 0.5 |r|^2`` is
    a 4-term float32 dot product, off by at most ``4u S`` (``u = 2^-24``,
    ``S = |q||r| + 0.5 |r|^2`` bounds the terms' magnitudes); two such scores
    differ by ``8u S``, ``16u S`` once doubled into a distance; forming
    ``|q|^2 - 2 s`` in float32 adds ``4u |q|^2``. The same bound caps the
    float64 gap between two rows that two correct searches may pick."""
    qn, rn2 = q.norm(dim=1), (r * r).sum(dim=1)
    return 2.0 ** -24 * (16.0 * (qn * rn2.sqrt() + 0.5 * rn2) + 4.0 * qn * qn)


def is_device_count(n) -> bool:
    """Whether a valid count is a 0-d tensor (kept on its device, never read
    by the host) rather than a python int."""
    return isinstance(n, Tensor)


def _device_counts(nq, nr, dev) -> Optional[Tensor]:
    """The kernels' int32 ``[2]`` device counts (nq, nr) when either count is
    a tensor, else None (the host ints go to the launch). Built by device
    ops alone, so that it can be captured in a CUDA graph."""
    if not (is_device_count(nq) or is_device_count(nr)):
        return None
    return torch.stack([n.to(device=dev, dtype=torch.int32) if is_device_count(n)
                        else torch.full((), n, dtype=torch.int32, device=dev)
                        for n in (nq, nr)])


def _walk(symbol, q4, r4, rbb, s0, i0, nq, nr, rt, visits, head=(),
          splits=(SPLIT_MIN, MAX_SPLITS)):
    """Launch a kernel on the walk core over ref tiles of ``rt`` rows:
    ``head`` holds the candidate kernel's table arguments, ``splits``
    (split_min, max_splits) how a query group's list is shared out. A count
    given as a tensor is read by the kernel on the device; the launch then
    takes the buffer's rows as the host's upper bound."""
    n_qt = q4.shape[0] // QT
    cfg = walk_config()
    per_tile = QT // (32 * cfg["qpt"])
    if QT % (32 * cfg["qpt"]):
        raise ValueError(f"QT={QT}: the kernels need a multiple of {32 * cfg['qpt']}")
    if rt % cfg["group"] or rt % min(cfg["chunk"], rt):
        raise ValueError(f"rt={rt}: the kernels stage chunks of min({cfg['chunk']}, rt) "
                         f"rows, in groups of {cfg['group']}")
    if (r4.shape[0] // rt + 1) * rt >= 2 ** 32 - 1:
        raise ValueError(f"{r4.shape[0]} ref rows: a (list position, row) rank needs 32 bits")
    items_max = walk_items_max(n_qt)
    if visits is not None and tuple(visits.shape) != (items_max, 3):
        raise ValueError(f"visits must be int64 [{items_max}, 3] on {q4.device}")
    # The kernel counts each query group's shares itself (no host
    # synchronisation); one zero-filled buffer holds its merged maxima and
    # its queue counters.
    groups = n_qt * per_tile
    scratch = torch.zeros(q4.shape[0] + groups // 2 + 1, dtype=torch.int64, device=q4.device)
    out_s, out_i = _outputs(q4)
    counts = _device_counts(nq, nr, q4.device)
    if counts is not None:
        nq, nr = q4.shape[0], r4.shape[0]
    _launch(symbol, q4.data_ptr(), r4.data_ptr(), rbb.data_ptr(), _ptr(s0), _ptr(i0), *head,
            n_qt, QT, nq, nr, r4.shape[0] // rt, rt, *splits, out_s.data_ptr(),
            out_i.data_ptr(), scratch.data_ptr(), scratch[q4.shape[0]:].data_ptr(),
            _ptr(visits), _ptr(counts))
    return out_s, out_i


@_Wrapper
def dense_kernel(self, q4, r4, rbb, s0, i0, nq, nr, rt: int, visits=None):
    """Replaces ``_dense_pallas_call``. ``q4 [n_qt*QT, 4]``, ``r4 [nrt*rt, 4]``,
    ``rbb [nrt, 8]``, seeds ``s0/i0 [n_qt*QT]`` or None; the valid counts
    ``nq``/``nr`` are python ints or 0-d tensors on the device (read there
    by the kernel, as the Pallas kernels read their scalar-prefetch
    counts). Returns the best
    score and index per query row. ``visits`` (optional, CUDA only): int64
    ``[walk_items_max(n_qt), 3]`` of zeros, which receives per work item
    (one query group's share of its list) the ref rows it staged, the
    (query, ref) pairs it scored, and of those the pairs another share
    scores too (only the resident kernel repeats any); rows past the call's
    items stay zero."""
    if not q4.is_cuda:
        return dense_plain(q4, r4, rbb, s0, i0, nq, nr, rt)
    _check(q4, r4, rbb, s0, i0, visits, rt)
    out = _walk("knn_dense_launch", q4, r4, rbb, s0, i0, nq, nr, rt, visits)
    self.launches += 1
    return out


@_Wrapper
def cand_kernel(self, q4, r4, rbb, s0, i0, cand, cnt, nq, nr, rt: int, visits=None):
    """Replaces ``_cand_pallas_call``. As ``dense_kernel``, plus the table
    ``cand [n_qt, MC]`` int32 (ref tiles in visit order) and ``cnt [n_qt]``
    int32 (entries used); seeds are required."""
    if not q4.is_cuda:
        return cand_plain(q4, r4, rbb, s0, i0, cand, cnt, nq, nr, rt)
    _check(q4, r4, rbb, s0, i0, visits, rt, ("cand", cand, torch.int32),
           ("cnt", cnt, torch.int32))
    if s0 is None or cand.shape[0] != q4.shape[0] // QT or cnt.shape != cand.shape[:1]:
        raise ValueError("cand_kernel needs seeds and a [n_qt, MC] table with [n_qt] counts")
    # The query tiles with the longest lists start first.
    order = torch.argsort(cnt, descending=True, stable=True).to(torch.int32)
    out = _walk("knn_cand_launch", q4, r4, rbb, s0, i0, nq, nr, rt, visits,
                head=(cand.data_ptr(), cnt.data_ptr(), order.data_ptr(), cand.shape[1]))
    self.launches += 1
    return out


@_Wrapper
def resident_kernel(self, q4, r4, rbb, s0, i0, nq, nr, st: int, visits=None):
    """Replaces ``_resident_pallas_call``. As ``dense_kernel`` with sub-tiles
    of ``st`` rows; ``rbb`` holds one box per staged chunk of
    ``min(chunk, st)`` rows (``walk_config()``). The plain version takes
    boxes of any equal part of a sub-tile."""
    if not q4.is_cuda:
        return resident_plain(q4, r4, rbb, s0, i0, nq, nr, st)
    _check(q4, r4, rbb, s0, i0, visits, st, box=min(walk_config()["chunk"], st))
    out = _walk("knn_resident_launch", q4, r4, rbb, s0, i0, nq, nr, st, visits,
                splits=(RES_SPLIT_MIN, RES_MAX_SPLITS))
    self.launches += 1
    return out


KERNELS = (dense_kernel, cand_kernel, resident_kernel)


# ---------------------------------------------------------------------------
# the dispatcher
# ---------------------------------------------------------------------------


def _pad_rows(x: Tensor, n: int, value: float = 0.0) -> Tensor:
    if x.shape[0] >= n:
        return x
    pad = x.new_full((n - x.shape[0],) + tuple(x.shape[1:]), value)
    return torch.cat([x, pad], dim=0)


def cand_table(q4: Tensor, s0: Tensor, r_pad: Tensor, nq, nr, rt: int):
    """The candidate kernel's table for a warm call: per query tile, every
    valid ref tile of ``rt`` rows whose box gap is below the tile's seeded
    worst-best distance, best first. The ulp guard admits borderline tiles
    the kernel's own bound might still visit. Returns (ref tile boxes
    ``[nrt, 8]``, table ``[n_qt, width]`` int32, counts ``[n_qt]`` int32).
    The table is as wide as the valid ref tiles for a host ``nr``, as all
    the buffer's tiles for a device one (the invalid ones never listed)."""
    nq_pad, n_qt = q4.shape[0], q4.shape[0] // QT
    q2p = (q4 * q4).sum(dim=1) - 1.0
    col = torch.arange(nq_pad, device=q4.device)
    d2_0 = torch.where(col < nq, q2p - 2.0 * s0, torch.full_like(q2p, -float("inf")))
    wb0 = d2_0.view(n_qt, QT).amax(dim=1)
    rbb = _tile_boxes(r_pad, rt)
    width = rbb.shape[0] if is_device_count(nr) else max(1, min(rbb.shape[0], -(-nr // rt)))
    lb2 = _box_gap2(_tile_boxes(q4, QT), rbb[:width])
    tile_valid = torch.arange(width, device=q4.device) * rt < nr
    lb2 = torch.where(tile_valid[None, :], lb2, torch.full_like(lb2, float("inf")))
    is_cand = lb2 < (wb0 * (1.0 + 1e-6) + 1e-9)[:, None]
    counts = is_cand.sum(dim=1).to(torch.int32)
    order = torch.argsort(torch.where(is_cand, lb2, torch.full_like(lb2, float("inf"))),
                          dim=1, stable=True).to(torch.int32)
    return rbb, order.contiguous(), counts


def knn(query: Tensor, ref: Tensor, nr=None, nq=None, init_idx=None,
        q_perm=None) -> Tuple[Tensor, Tensor]:
    """Top-1 KNN: for each query point, its nearest reference point.

    Args:
      query: ``[Nq, 3]``; ref: ``[Nr, 3]``.
      nr / nq: valid ref / query counts, python ints or 0-d integer
        tensors on the query's device; default all. A tensor count is never
        read by the host: the kernels read it on the device, so the call
        can be captured in a CUDA graph. Refs past ``nr`` never match;
        results past ``nq`` are undefined.
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
    nr = Nr if nr is None else nr if is_device_count(nr) else int(nr)
    nq = Nq if nq is None else nq if is_device_count(nq) else int(nq)
    dev = query.device
    nq_pad = -(-Nq // QT) * QT
    nr_pad = -(-Nr // RT) * RT
    q = query.float()

    # Candidate-table gate and query Morton sort (knn.py:340-386 of the JAX
    # package): sorted queries make each query tile spatially tight, so its
    # seeded threshold and candidate set stay small. The table is as wide as
    # the valid ref tiles, so it cannot overflow and the call makes no host
    # decision. It is taken whenever the call is warm, the refs are too many
    # for the resident kernel (which holds small ref sets whole) and there
    # are at most MAX_TABLE_TILES query tiles (the frame->map search has
    # 320), which bounds the table's size; any other call takes the resident
    # or the dense kernel.
    rt_c = min(RT_CAND, RT)
    warm = init_idx is not None
    n_qt = nq_pad // QT
    resident_fits = nr_pad <= RES_MAX_ROWS and nr_pad % min(ST, RT) == 0
    use_cand = warm and not resident_fits and n_qt <= MAX_TABLE_TILES
    qperm = None
    if use_cand:
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

    if use_cand:
        rbb_c, order, counts = cand_table(q4, s0, r_pad, nq, nr, rt_c)
        best_s, best_i = cand_kernel(q4, r4, rbb_c, s0, i0, order, counts, nq, nr, rt_c)
    elif resident_fits:
        # The resident kernel when the whole ref set is small, else dense:
        # one box per chunk the kernel stages (the plain version takes one
        # per sub-tile).
        st = min(ST, RT)
        box = min(walk_config()["chunk"], st) if q4.is_cuda else st
        best_s, best_i = resident_kernel(q4, r4, _tile_boxes(r_pad, box), s0, i0, nq, nr, st)
    else:
        best_s, best_i = dense_kernel(q4, r4, _tile_boxes(r_pad, RT), s0, i0, nq, nr, RT)

    best_s, best_i = best_s[:Nq], best_i[:Nq]
    d2 = ((q * q).sum(dim=1) - 2.0 * best_s).clamp(min=0.0)
    if qperm is not None:
        # Row p of the sorted results belongs to query qperm[p].
        d2 = torch.empty_like(d2).scatter_(0, qperm, d2)
        best_i = torch.empty_like(best_i).scatter_(0, qperm, best_i)
    return d2, best_i
