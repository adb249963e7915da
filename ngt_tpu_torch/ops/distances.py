"""Batched distances for every metric of the reference (the port's
counterpart of ``ngt_tpu/ops/distances.py``).

* ``pairwise(metric, Q, X)`` — [B, D] x [N, D] -> [B, N];
* ``gathered(metric, Q, Xs)`` — [B, D] x [B, E, D] -> [B, E], the per-hop
  scorer of the graph search;
* ``seed_scores`` — selection-only scores used to pick seed ids.

Metric definitions follow the reference exactly:
  L1/L2:            PrimitiveComparator.h:143-313
  NormalizedL2:     sqrt(2 - 2 dot)             (:226-234)
  Hamming:          popcount(a XOR b)           (:340-354)
  Jaccard:          1 - |a AND b| / |a OR b|    (:375-392)
  SparseJaccard:    1 - |ids_a ∩ ids_b| / |ids_a ∪ ids_b|  (:399-418)
  Cosine:           1 - dot/(|a||b|)            (:487-553)
  Angle:            acos(cos similarity)        (:571-593)
  Poincare:         acosh(1 + 2|a-b|^2 / ((1-|a|^2)(1-|b|^2)))  (:596-618)
  Lorentz:          acosh(a0*b0 - sum_{i>0} ai*bi)              (:621-637)

Where XLA fuses a ``[B, N, D]`` broadcast, eager torch would materialize
it, so three metrics take another exact route:

* Hamming and Jaccard count bits pairwise with matmuls over the unpacked
  bits: ``popcount(a^b) = |a| + |b| - 2 a.b``, ``|a&b| = a.b`` and
  ``|a|b| = |a| + |b| - a.b``.  The counts are integers of at most
  8 * D, exact in f32.  The gathered form counts the bits of
  ``a^b``, ``a&b`` and ``a|b`` through a 256-entry table (its broadcast is
  the size of the gathered rows);
* sparse Jaccard multiplies 0/1 indicator rows over the ids present
  (exact small counts) while they fit a byte budget, else looks each row
  id up in the query's sorted ids (``searchsorted``) in query blocks of
  bounded bytes;
* L1 is ``torch.cdist(p=1)`` pairwise; the gathered form's broadcast is
  the size of the gathered rows.

Feature dims are zero-padded (distance-neutral for every dense metric);
sparse rows are int32 id sets padded with -1.

Precision: distance contractions stay full fp32.  The JAX package asks for
``Precision.HIGHEST`` on every such matmul; the port's form of that rule is
to keep TF32 off for matmuls and convolutions, set here explicitly because
the defaults are process-wide and another library may have changed them.
Square roots are correctly rounded (``sqrt``), as XLA's and CUDA's are.
"""

from __future__ import annotations

import torch

from ngt_tpu_torch.properties import DistanceType

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_F32 = torch.float32

#: metrics whose stored vectors are L2-normalized at insertion time
#: (reference ObjectSpaceRepository.h:560-618, ObjectSpace.h:251)
NORMALIZED_METRICS = frozenset({
    DistanceType.NORMALIZED_L2,
    DistanceType.NORMALIZED_COSINE,
    DistanceType.NORMALIZED_ANGLE,
})

#: plain angular metrics: stored UN-normalized (the reference computes them
#: with explicit norms), so a dot-based seed surrogate divides by the norms
ANGULAR_METRICS = frozenset({DistanceType.COSINE, DistanceType.ANGLE})

#: metrics computed on uint8 bit patterns (stored as uint8, never cast)
BITWISE_METRICS = frozenset({DistanceType.HAMMING, DistanceType.JACCARD})

#: bytes a query block of the sparse-Jaccard lookup may hold
_BLOCK_BYTES = 1 << 28
#: sorts after every int32 id: the padding of a sorted sparse row
_PAST_IDS = 1 << 40
#: bytes the sparse-Jaccard lookup holds per (query, row id): the id, its
#: position, the id found there and the comparison
SPARSE_PAIR_BYTES = 32


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root.  CUDA's ``sqrt`` is; the
    CPU's vectorized one is not (torch 2.13 on AVX-512 rounds about 0.7% of
    float32 inputs one ulp off), so on the CPU the root is taken in float64,
    whose rounding back to float32 is exact for a square root."""
    if x.device.type == "cpu":
        return torch.sqrt(x.to(torch.float64)).to(x.dtype)
    return torch.sqrt(x)


def _acos_safe(x):
    return torch.acos(torch.clamp(x, -1.0, 1.0))


def _acosh_safe(x):
    return torch.acosh(torch.clamp(x, min=1.0))


def sq_norms(x: torch.Tensor) -> torch.Tensor:
    """Row squared norms, f32. x: [..., D]."""
    xf = x.to(_F32)
    return (xf * xf).sum(-1)


def _bits(x: torch.Tensor) -> torch.Tensor:
    """uint8 rows [..., D] -> their bits [..., 8D] as f32 0/1."""
    shifts = torch.arange(8, dtype=torch.uint8, device=x.device)
    b = (x.to(torch.uint8)[..., None] >> shifts) & 1
    return b.reshape(*x.shape[:-1], x.shape[-1] * 8).to(_F32)


def _bitwise_pairwise(metric, q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Hamming or Jaccard of all pairs from the unpacked bits."""
    qb, xb = _bits(q), _bits(x)
    inter = qb @ xb.T
    nq = qb.sum(-1)[:, None]
    nx = xb.sum(-1)[None, :]
    if metric == DistanceType.HAMMING:
        return nq + nx - 2.0 * inter
    return 1.0 - inter / torch.clamp(nq + nx - inter, min=1.0)


#: bits set in each byte value
_POPCOUNT = torch.tensor([bin(v).count("1") for v in range(256)], dtype=torch.int32)
_popcount_on: dict = {}


def _popcount_sum(v: torch.Tensor) -> torch.Tensor:
    """Bits set in each row of uint8 v [..., D], as f32."""
    lut = _popcount_on.get(v.device)
    if lut is None:
        lut = _popcount_on[v.device] = _POPCOUNT.to(v.device)
    return lut[v.to(torch.int64)].sum(-1).to(_F32)


def _bitwise_gathered(metric, q: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Hamming or Jaccard of each query against its own rows [B, E, D]."""
    qb = q.to(torch.uint8)[:, None, :]
    xb = xs.to(torch.uint8)
    if metric == DistanceType.HAMMING:
        return _popcount_sum(qb ^ xb)
    inter = _popcount_sum(qb & xb)
    return 1.0 - inter / torch.clamp(_popcount_sum(qb | xb), min=1.0)


def _sparse_jaccard(q: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """q [B, L] against xs [B, M, L], each query its own id rows: the
    count of row ids found in the query's sorted ids, which is the
    reference's count of query ids found in the row when each row's valid
    ids are unique (compareSparseJaccardDistance,
    PrimitiveComparator.h:399-418)."""
    b, m, l = xs.shape
    q64 = q.to(torch.int64)
    srt = torch.sort(torch.where(q64 < 0, _PAST_IDS, q64), dim=-1).values
    vals = xs.to(torch.int64).reshape(b, m * l)
    pos = torch.searchsorted(srt, vals).clamp_(max=l - 1)
    found = (srt.gather(1, pos) == vals) & (vals >= 0)
    inter = found.view(b, m, l).sum(-1, dtype=torch.int32).to(_F32)
    nq = (q >= 0).sum(-1, dtype=torch.int32).to(_F32)
    nx = (xs >= 0).sum(-1, dtype=torch.int32).to(_F32)
    return 1.0 - inter / torch.clamp(nq[:, None] + nx - inter, min=1.0)


def _sparse_jaccard_pairwise(q_ids: torch.Tensor, x_ids: torch.Tensor) -> torch.Tensor:
    """q_ids [B, L], x_ids [N, L] int32, -1 padded -> [B, N].  While the
    0/1 indicator rows over the ids present fit ``_BLOCK_BYTES``, the
    intersections are one matmul of them (exact small counts); else the
    ``searchsorted`` lookup in query blocks of at most ``_BLOCK_BYTES``."""
    b, n, l = q_ids.shape[0], x_ids.shape[0], x_ids.shape[1]
    ids = torch.cat([q_ids.reshape(-1), x_ids.reshape(-1)]).to(torch.int64)
    vocab = torch.unique(ids[ids >= 0])
    if vocab.numel() * (b + n) * 4 <= _BLOCK_BYTES:

        def indicator(rows):
            r = rows.to(torch.int64)
            col = torch.searchsorted(vocab, r.clamp(min=0))
            ind = torch.zeros((r.shape[0], vocab.numel() + 1), dtype=_F32, device=r.device)
            ind.scatter_(1, torch.where(r >= 0, col, vocab.numel()), 1.0)
            return ind[:, :-1]

        inter = indicator(q_ids) @ indicator(x_ids).T
        nq = (q_ids >= 0).sum(-1, dtype=torch.int32).to(_F32)
        nx = (x_ids >= 0).sum(-1, dtype=torch.int32).to(_F32)
        return 1.0 - inter / torch.clamp(nq[:, None] + nx[None, :] - inter, min=1.0)
    step = max(1, _BLOCK_BYTES // max(n * l * SPARSE_PAIR_BYTES, 1))
    return torch.cat([
        _sparse_jaccard(q_ids[i : i + step],
                        x_ids[None].expand(min(step, b - i), n, l))
        for i in range(0, b, step)
    ])


# --------------------------------------------------------------------------
# pairwise: [B, D] x [N, D] -> [B, N]
# --------------------------------------------------------------------------


def pairwise(metric, q: torch.Tensor, x: torch.Tensor,
             x_sqnorm: torch.Tensor | None = None) -> torch.Tensor:
    """Full pairwise distance matrix (the analogue of
    ObjectSpaceRepository::linearSearch, ObjectSpaceRepository.h:466-502)."""
    metric = DistanceType(metric)
    if metric in BITWISE_METRICS:
        return _bitwise_pairwise(metric, q, x)
    if metric == DistanceType.SPARSE_JACCARD:
        return _sparse_jaccard_pairwise(q, x)

    qf = q.to(_F32)
    xf = x.to(_F32)
    if metric == DistanceType.L1:
        return torch.cdist(qf, xf, p=1.0)

    dot = qf @ xf.T
    if metric == DistanceType.NORMALIZED_COSINE:
        return 1.0 - dot
    if metric == DistanceType.NORMALIZED_ANGLE:
        return _acos_safe(dot)
    if metric == DistanceType.NORMALIZED_L2:
        return sqrt(torch.clamp(2.0 - 2.0 * dot, min=0.0))

    q_sq = (qf * qf).sum(-1)
    x_sq = sq_norms(xf) if x_sqnorm is None else x_sqnorm.to(_F32)
    if metric == DistanceType.L2:
        d2 = q_sq[:, None] + x_sq[None, :] - 2.0 * dot
        return sqrt(torch.clamp(d2, min=0.0))
    if metric in ANGULAR_METRICS:
        denom = sqrt(torch.clamp(q_sq[:, None] * x_sq[None, :], min=1e-30))
        cos = dot / denom
        return 1.0 - cos if metric == DistanceType.COSINE else _acos_safe(cos)
    if metric == DistanceType.POINCARE:
        d2 = torch.clamp(q_sq[:, None] + x_sq[None, :] - 2.0 * dot, min=0.0)
        denom = torch.clamp((1.0 - q_sq)[:, None] * (1.0 - x_sq)[None, :], min=1e-30)
        return _acosh_safe(1.0 + 2.0 * d2 / denom)
    if metric == DistanceType.LORENTZ:
        # a0*b0 - sum_{i>0} = 2*a0*b0 - dot
        return _acosh_safe(2.0 * torch.outer(qf[:, 0], xf[:, 0]) - dot)
    raise ValueError(f"unsupported metric: {metric!r}")


def seed_scores(metric, q: torch.Tensor, reps: torch.Tensor,
                rep_sq: torch.Tensor | None = None) -> torch.Tensor:
    """Scores for SEED SELECTION only; graph_search re-scores the chosen
    seeds exactly, so no value from here reaches a result.

    * normalized and angular metrics: ``-dot`` of the bf16-rounded rows,
      divided by the rep norms (``rep_sq``) for the plain angular ones,
      whose rows are stored un-normalized;
    * L2: squared L2 between bf16-rounded rows centered on the
      representative mean (translation invariance keeps the ranking;
      centering keeps bf16 resolution);
    * every other metric: the exact ``pairwise``.

    The products of the bf16-rounded values are summed in f32, as the
    reference's bf16 matmul with f32 accumulation does."""
    metric = DistanceType(metric)
    if metric in NORMALIZED_METRICS or metric in ANGULAR_METRICS:
        dot = (q.to(_F32).to(torch.bfloat16).to(_F32)
               @ reps.to(torch.bfloat16).to(_F32).T)
        if metric in ANGULAR_METRICS:
            r_sq = sq_norms(reps) if rep_sq is None else rep_sq.to(_F32)
            dot = dot * torch.rsqrt(torch.clamp(r_sq, min=1e-30))[None, :]
        return -dot
    if metric == DistanceType.L2:
        qf = q.to(_F32)
        rf = reps.to(_F32)
        mu = rf.mean(0)
        qc = qf - mu[None, :]
        rc = rf - mu[None, :]
        dot = qc.to(torch.bfloat16).to(_F32) @ rc.to(torch.bfloat16).to(_F32).T
        q_sq = (qc * qc).sum(-1)
        r_sq = (rc * rc).sum(-1)
        return q_sq[:, None] + r_sq[None, :] - 2.0 * dot
    return pairwise(metric, q, reps, x_sqnorm=rep_sq)


# --------------------------------------------------------------------------
# gathered: [B, D] x [B, E, D] -> [B, E]   (per-hop scorer of graph search)
# --------------------------------------------------------------------------


def gathered(metric, q: torch.Tensor, xs: torch.Tensor,
             xs_sqnorm: torch.Tensor | None = None,
             q_sqnorm: torch.Tensor | None = None) -> torch.Tensor:
    """Distances from each query [B, D] to its own gathered rows [B, E, D]."""
    metric = DistanceType(metric)
    if metric in BITWISE_METRICS:
        return _bitwise_gathered(metric, q, xs)
    if metric == DistanceType.SPARSE_JACCARD:
        return _sparse_jaccard(q, xs)

    qf = q.to(_F32)
    xf = xs.to(_F32)
    if metric == DistanceType.L1:
        return (qf[:, None, :] - xf).abs().sum(-1)
    if metric == DistanceType.L2:
        # the exact elementwise form, immune to the norm-trick cancellation
        diff = qf[:, None, :] - xf
        return sqrt((diff * diff).sum(-1))

    dot = torch.einsum("bd,bed->be", qf, xf)
    if metric == DistanceType.NORMALIZED_COSINE:
        return 1.0 - dot
    if metric == DistanceType.NORMALIZED_ANGLE:
        return _acos_safe(dot)
    if metric == DistanceType.NORMALIZED_L2:
        return sqrt(torch.clamp(2.0 - 2.0 * dot, min=0.0))
    if metric == DistanceType.LORENTZ:
        return _acosh_safe(2.0 * qf[:, 0:1] * xf[:, :, 0] - dot)

    q_sq = (qf * qf).sum(-1) if q_sqnorm is None else q_sqnorm.to(_F32)
    x_sq = (xf * xf).sum(-1) if xs_sqnorm is None else xs_sqnorm.to(_F32)
    if metric in ANGULAR_METRICS:
        denom = sqrt(torch.clamp(q_sq[:, None] * x_sq, min=1e-30))
        cos = dot / denom
        return 1.0 - cos if metric == DistanceType.COSINE else _acos_safe(cos)
    if metric == DistanceType.POINCARE:
        d2 = torch.clamp(q_sq[:, None] + x_sq - 2.0 * dot, min=0.0)
        denom = torch.clamp((1.0 - q_sq)[:, None] * (1.0 - x_sq), min=1e-30)
        return _acosh_safe(1.0 + 2.0 * d2 / denom)
    raise ValueError(f"unsupported metric: {metric!r}")


def normalize_rows(x: torch.Tensor) -> torch.Tensor:
    """L2-normalize rows in f32; a zero row stays zero (the store rejects
    zero vectors on the host, ObjectSpace.h:251-266)."""
    xf = x.to(_F32)
    n = sqrt((xf * xf).sum(-1, keepdim=True))
    return torch.where(n > 0, xf / torch.clamp(n, min=1e-30), 0.0)


def needs_normalization(metric) -> bool:
    return DistanceType(metric) in NORMALIZED_METRICS
