"""Similar-hand mining on one device (counterpart of the single-device half
of ``simhand_tpu/mining/similar_hands.py``).

Every hand is paired with its k most similar hands from *other* videos by
MPJPE over its 21 2D keypoints (the paper's metric, §3). The keypoint
corpus lives on the device once; query chunks stream database chunks
through the distance pass and a running top-k, so the peak memory is a few
(query_chunk, db_chunk) planes. Same-video candidates, the query itself and
the database's pad columns are masked to +inf.

The JAX package computes the distance pass in XLA (no Pallas kernel lies on
this path), and so does the port, with plain PyTorch ops. Its arithmetic is
the one XLA's CPU backend gives the reference, the same on the CPU and
on the card, so the card's distances equal the CPU's bit for bit:

  * each joint's term is ``sqrt(fma(dx, dx, dy * dy))``: ``dx`` and ``dy``
    are float32 differences, ``dy * dy`` is rounded to float32, and XLA's
    multiply-add is rounded once. The port forms the sum in float64 (the
    product of two float32 values is exact there) and rounds it to float32;
    separate ATen ops never contract into an FMA, on either device. That is
    two roundings, not one. The float64 sum is exact, and the result the
    FMA's, unless one term dwarfs the other (about ``|dx| < 2**-2.5 |dy|``
    or ``|dx| > 2**14.5 |dy|``: the exact sum then needs more than 53
    bits); even there the two differ, by one float32 ulp, only where the
    float64 sum falls exactly halfway between two float32 values (about
    one such sum in 2**28, or where ``dx * dx`` itself is such a halfway
    value and ``dy`` is tiny beside ``dx``: at ``dx = 4097 * 2**-13``,
    ``dy = 2**-40`` the FMA rounds up and the port to even). So the
    distances equal JAX's bit for bit on the corpora held (random and
    integer-grid keypoints), not by construction; an exact route would add
    a TwoSum and a round-to-odd step, about ten more passes a joint;
  * the square root is taken in float64 and rounded to float32, which is the
    correctly rounded float32 root (PyTorch's vectorised CPU float32
    ``sqrt`` is not correctly rounded);
  * the terms are summed over the joints in order in float32, and the sum is
    multiplied by the float32 reciprocal of 21 (XLA's rewrite of ``/ 21``).

The running top-k keeps ``lax.top_k``'s order among ties: the running best
before the chunk's columns, a lower index first. That is the first k of a
stable ascending sort of ``[best, chunk]``; the port takes the chunk's first
k by ``min`` (which returns the first index of the minimum) and sorts the
2k candidates stably.

With a ``mesh`` (a ``parallel.mesh`` axis) the queries are split over the
ranks: ``make_sharded_topk_all`` keeps the whole database on every rank,
and ``make_ring_topk_all`` (``shard_db``) splits it too and passes each
rank's block one hop round the ring (``ppermute``) after every round, so
each query meets the database block by block in rotation order: its own
rank's block first, then the previous rank's. The ring's ties can fall to
another candidate than on one device, as JAX's ring's do; the replicated
database's cannot. Each rank's result is all-gathered, so every rank
returns the whole (N, k) arrays.

Output plugs straight into the Hand100M v1-1 annotation schema
(``positive_sample`` / ``distance`` fields).
"""
from __future__ import annotations

import numpy as np
import torch

from simhand_tpu_torch.device import resolve_device

# the database's pad rows (the JAX package's: far away, a video id no query has)
PAD_KEYPOINT = 1e9
PAD_DB_VIDEO = -2
# a padded query's video id
PAD_QUERY_VIDEO = -3


def _reciprocal(n: int, device) -> torch.Tensor:
    """float32(1) / float32(n), correctly rounded, as a 0-dim float32 tensor."""
    one = torch.tensor(1.0, dtype=torch.float32)
    return (one / torch.tensor(float(n), dtype=torch.float32)).to(device)


def _chunk_distances(q: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """(Q, 21, 2) x (C, 21, 2) float32 -> (Q, C) float32 MPJPE, one joint at a
    time, in the arithmetic of the module docstring. Four (Q, C) planes are
    live: the float32 sum, a float64 term and two float32 temporaries."""
    Q, C, J = q.shape[0], db.shape[0], q.shape[1]
    acc = torch.zeros((Q, C), dtype=torch.float32, device=q.device)
    term = torch.empty((Q, C), dtype=torch.float64, device=q.device)
    dy2 = torch.empty((Q, C), dtype=torch.float32, device=q.device)
    rounded = torch.empty((Q, C), dtype=torch.float32, device=q.device)
    for j in range(J):
        # float32 differences (computed in float32, held in float64 for dx)
        torch.sub(q[:, j, 0, None], db[None, :, j, 0], out=term)
        torch.sub(q[:, j, 1, None], db[None, :, j, 1], out=dy2)
        dy2.mul_(dy2)
        term.mul_(term)              # dx * dx, exact
        term.add_(dy2)               # + float32(dy * dy), rounded to float64
        rounded.copy_(term)          # and to float32 (see the docstring)
        term.copy_(rounded)
        term.sqrt_()
        rounded.copy_(term)          # the correctly rounded float32 root
        acc.add_(rounded)
    return acc.mul_(_reciprocal(J, q.device))


def _merge_topk(best_d, best_i, d, col_ids, k: int):
    """The first k of a stable ascending sort of ``[best, chunk]`` by
    distance: the chunk's first k (``min`` takes the first index of the
    minimum; each one taken is set to +inf in ``d``), then a stable sort of
    the 2k candidates, the running best first."""
    cand_d, cand_i = [], []
    for t in range(min(k, d.shape[1])):
        m, j = d.min(dim=1)
        cand_d.append(m)
        cand_i.append(col_ids[j])
        if t + 1 < k:
            d.scatter_(1, j[:, None], float("inf"))
    cat_d = torch.cat([best_d, torch.stack(cand_d, 1)], dim=1)
    cat_i = torch.cat([best_i, torch.stack(cand_i, 1)], dim=1)
    order = torch.sort(cat_d, dim=1, stable=True).indices[:, :k]
    return cat_d.gather(1, order), cat_i.gather(1, order)


def topk_similar(
    queries: torch.Tensor,      # (Q, 21, 2) float32
    query_vids: torch.Tensor,   # (Q,) int32 video ids
    query_ids: torch.Tensor,    # (Q,) int32 global indices (for the self mask)
    db: torch.Tensor,           # (N, 21, 2) float32
    db_vids: torch.Tensor,      # (N,) int32
    k: int = 1,
    db_chunk: int = 8192,
):
    """Top-k most similar other-video hands for each query, all tensors on
    one device. Returns (distances (Q, k) float32, db indices (Q, k) int32);
    a slot with no valid candidate keeps +inf and -1."""
    Q, N = queries.shape[0], db.shape[0]
    dev = queries.device
    pad = (-N) % db_chunk
    if pad:
        db = torch.cat([db, torch.full((pad,) + tuple(db.shape[1:]), PAD_KEYPOINT,
                                       dtype=db.dtype, device=dev)])
        db_vids = torch.cat([db_vids, torch.full((pad,), PAD_DB_VIDEO, dtype=db_vids.dtype,
                                                 device=dev)])
    best_d = torch.full((Q, k), float("inf"), dtype=queries.dtype, device=dev)
    best_i = torch.full((Q, k), -1, dtype=torch.int32, device=dev)
    cols = torch.arange(db_chunk, dtype=torch.int32, device=dev)
    for lo in range(0, db.shape[0], db_chunk):
        d = _chunk_distances(queries, db[lo:lo + db_chunk])
        d.masked_fill_(query_vids[:, None] == db_vids[None, lo:lo + db_chunk], float("inf"))
        # self: the query's own column where it falls in this chunk (a
        # scatter without a host sync; other rows write their value back)
        local = query_ids.long() - lo
        here = (local >= 0) & (local < db_chunk)
        at = local.clamp(0, db_chunk - 1)[:, None]
        d.scatter_(1, at, d.gather(1, at).masked_fill_(here[:, None], float("inf")))
        # pad columns carry finite (~1e9-scale) distances and a -2 vid that
        # never matches: masked, or a query with no valid cross-video
        # candidate would select a pad index >= N
        if lo + db_chunk > N:
            d[:, N - lo:] = float("inf")
        best_d, best_i = _merge_topk(best_d, best_i, d, cols + lo, k)
    return best_d, best_i


def _topk_all_queries(q_kp, q_vids, q_ids, db, db_vids, k: int, query_chunk: int,
                      db_chunk: int, progress: bool = False):
    """Every query chunk of (q_kp, q_vids, q_ids) streamed against the whole
    database through ``topk_similar``; the results stay on the device."""
    Q = q_kp.shape[0]
    out = []
    for lo in range(0, Q, query_chunk):
        hi = lo + query_chunk
        out.append(topk_similar(q_kp[lo:hi], q_vids[lo:hi], q_ids[lo:hi], db, db_vids, k=k,
                                db_chunk=db_chunk))
        if progress:
            print(f"dispatched {min(hi, db.shape[0])}/{db.shape[0]}", flush=True)
    return torch.cat([d for d, _ in out]), torch.cat([i for _, i in out])


def topk_similar_all(
    kp: torch.Tensor,        # (Q, 21, 2), Q padded to a multiple of query_chunk
    vids: torch.Tensor,      # (Q,)
    db: torch.Tensor,        # (N, 21, 2): the UNPADDED corpus
    db_vids: torch.Tensor,   # (N,)
    k: int = 1,
    query_chunk: int = 8192,
    db_chunk: int = 8192,
    progress: bool = False,
):
    """Whole-corpus mining: every query chunk streamed against the database
    through ``topk_similar``, the results left on the device (the caller
    fetches once). The database is passed apart from the (possibly padded)
    queries, so query padding never enters the candidate set: zero-keypoint
    pad rows have small finite MPJPE to real hands and would otherwise be
    mined as bogus positives. ``progress`` prints the queries queued."""
    q_ids = torch.arange(kp.shape[0], dtype=torch.int32, device=kp.device)
    return _topk_all_queries(kp, vids, q_ids, db, db_vids, k, query_chunk, db_chunk, progress)


def _rows(axis, *tensors):
    """This rank's equal share of each tensor's rows."""
    n = tensors[0].shape[0] // axis.size
    return [t[axis.index * n:(axis.index + 1) * n] for t in tensors]


def make_sharded_topk_all(mesh, k: int, query_chunk: int, db_chunk: int):
    """(q_kp, q_vids, q_ids, db, db_vids) -> (distances, indices) of every
    query: each rank of ``mesh`` mines its share of the queries (their
    count a multiple of ``query_chunk`` times the ranks) against the whole
    database, which every rank holds, and the results are all-gathered."""

    def run(q_kp, q_vids, q_ids, db, db_vids):
        d, i = _topk_all_queries(*_rows(mesh, q_kp, q_vids, q_ids), db, db_vids, k,
                                 query_chunk, db_chunk)
        return mesh.gather_raw(d), mesh.gather_raw(i)

    return run


def _merge_block(q, qv, qi, blk, blk_vids, blk_ids, best_d, best_i, k: int, db_chunk: int):
    """Merges one database block, with explicit global ids, into the running
    top-k of the queries, ``db_chunk`` rows at a time as ``topk_similar``
    does; pad rows carry id -1 and are masked with same-video and self."""
    for lo in range(0, blk.shape[0], db_chunk):
        cv, ci = blk_vids[lo:lo + db_chunk], blk_ids[lo:lo + db_chunk]
        d = _chunk_distances(q, blk[lo:lo + db_chunk])
        mask = (qv[:, None] == cv[None, :]) | (qi[:, None] == ci[None, :]) | (ci[None, :] < 0)
        d.masked_fill_(mask, float("inf"))
        best_d, best_i = _merge_topk(best_d, best_i, d, ci, k)
    return best_d, best_i


def make_ring_topk_all(mesh, k: int, query_chunk: int, db_chunk: int):
    """(q_kp, q_vids, q_ids, db, db_vids, db_ids) -> (distances, indices) of
    every query with the database split over ``mesh`` too: each rank holds
    its share of the queries and one block of the database (the counts
    multiples of ``query_chunk`` and ``db_chunk`` times the ranks), merges
    every query chunk against the block it holds, then sends the block to
    the next rank (``ppermute``); after as many rounds as ranks every query
    has met the whole database. The results are all-gathered."""

    def run(q_kp, q_vids, q_ids, db, db_vids, db_ids):
        q_kp, q_vids, q_ids = _rows(mesh, q_kp, q_vids, q_ids)
        blk, bv, bids = _rows(mesh, db, db_vids, db_ids)
        starts = range(0, q_kp.shape[0], query_chunk)
        best = [(torch.full((query_chunk, k), float("inf"), dtype=q_kp.dtype, device=q_kp.device),
                 torch.full((query_chunk, k), -1, dtype=torch.int32, device=q_kp.device))
                for _ in starts]
        for _ in range(mesh.size):
            best = [_merge_block(q_kp[lo:lo + query_chunk], q_vids[lo:lo + query_chunk],
                                 q_ids[lo:lo + query_chunk], blk, bv, bids, *b, k, db_chunk)
                    for lo, b in zip(starts, best)]
            blk, bv, bids = mesh.ppermute(blk), mesh.ppermute(bv), mesh.ppermute(bids)
        d = torch.cat([d for d, _ in best])
        i = torch.cat([i for _, i in best])
        return mesh.gather_raw(d), mesh.gather_raw(i)

    return run


def _pad(t: torch.Tensor, pad: int, value) -> torch.Tensor:
    """t with ``pad`` rows of ``value`` after it."""
    if not pad:
        return t
    return torch.cat([t, torch.full((pad,) + tuple(t.shape[1:]), value, dtype=t.dtype,
                                    device=t.device)])


def mine_similar_hands(
    keypoints: np.ndarray,    # (N, 21, 2) normalized 2D keypoints
    video_ids: np.ndarray,    # (N,) int
    k: int = 1,
    query_chunk: int = 4096,
    db_chunk: int = 8192,
    mesh=None,
    progress: bool = False,
    single_program: bool | None = None,
    shard_db: bool = False,
    device=None,
):
    """Full-corpus mining: every hand paired with its k most similar hands
    from other videos, on ``device`` (the card unless the caller asks for
    the CPU). Returns (distances (N, k) float32, indices (N, k) int32) as
    numpy arrays, on every rank of ``mesh``.

    With a ``mesh`` the queries are split over its ranks and the database
    is whole on each (``make_sharded_topk_all``), or split too with
    ``shard_db`` (``make_ring_topk_all``). Pads: a query's video -3 (its
    id counting on from N), a database row's video -2 and id -1.

    ``single_program`` is JAX's choice between one scanned program and a
    dispatch a query chunk. Eager PyTorch runs both the same way, one
    ``topk_similar`` a query chunk and one fetch at the end, so it only
    keeps the signature.
    """
    if shard_db and mesh is None:
        raise ValueError("shard_db=True requires a mesh")
    dev = resolve_device(device)
    N = keypoints.shape[0]
    kp = torch.from_numpy(np.ascontiguousarray(keypoints, np.float32)).to(dev)
    vids = torch.from_numpy(np.ascontiguousarray(video_ids, np.int32)).to(dev)
    n_dev = 1 if mesh is None else mesh.size

    def ids(lo, hi):
        return torch.arange(lo, hi, dtype=torch.int32, device=dev)

    if shard_db:
        qpad = (-N) % (query_chunk * n_dev)
        dpad = (-N) % (db_chunk * n_dev)
        fn = make_ring_topk_all(mesh, k, query_chunk, db_chunk)
        d, i = fn(_pad(kp, qpad, 0.0), _pad(vids, qpad, PAD_QUERY_VIDEO), ids(0, N + qpad),
                  _pad(kp, dpad, 0.0), _pad(vids, dpad, PAD_DB_VIDEO), _pad(ids(0, N), dpad, -1))
    else:
        pad = (-N) % (query_chunk * n_dev)
        kp_p, vids_p = _pad(kp, pad, 0.0), _pad(vids, pad, PAD_QUERY_VIDEO)
        if mesh is None:
            d, i = topk_similar_all(kp_p, vids_p, kp, vids, k=k, query_chunk=query_chunk,
                                    db_chunk=db_chunk, progress=progress)
        else:
            d, i = make_sharded_topk_all(mesh, k, query_chunk, db_chunk)(
                kp_p, vids_p, ids(0, N + pad), kp, vids)
    return d[:N].cpu().numpy(), i[:N].cpu().numpy()


def attach_positives(annotations: list[dict], distances: np.ndarray,
                     indices: np.ndarray) -> list[dict]:
    """Writes mining results into annotation dicts (v1-1 schema fields).

    Raises on the -1 no-candidate sentinel (a query whose every candidate
    shares its video, e.g. k too large or a single-video corpus) rather
    than silently wrapping to the last annotation."""
    for n, (a, d_row, i_row) in enumerate(zip(annotations, distances, indices)):
        if (np.asarray(i_row) < 0).any():
            raise ValueError(
                f"annotation #{n} (hand_id {a.get('hand_id')}): no valid "
                "cross-video candidate for at least one of its top-k "
                "slots — shrink k or check the corpus has >1 video"
            )
        a["positive_sample"] = [int(annotations[j]["hand_id"]) for j in i_row]
        a["distance"] = [float(x) for x in d_row]
    return annotations
