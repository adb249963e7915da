"""Product quantization (the port's counterpart of ``ngt_tpu/quant/pq.py``):
codebooks, encoding, asymmetric-distance lookup tables, after the
reference's NGTQ quantizer (NGTQ/Quantizer.h).

* codebook training: all M subspace codebooks train in one batched k-means
  (``quant/clustering.py``), chunked over subspaces as the reference does;
* encoding: the nearest centroid per subspace, one batched matmul over the
  ``[M, N, dsub]`` stack; codes are ``[N, M]`` uint8;
* lookup tables: per query ``[M, ksub]`` squared subvector distances
  (``createFloatL2DistanceLookup``, Quantizer.h:683-760);
* scoring a set of codes (ADC) is a ``torch.gather`` of the table by the
  codes and a sum over M.  The reference writes it as a one-hot masked sum,
  its TPU stand-in for the ``vpshufb`` LUT shuffle (Quantizer.h:957-1095);
  each one-hot row picks exactly one entry, so the values agree and only
  the order of the M-sum may differ.

4-bit codes pack two to a byte, the even subspace in the low nibble
(``pack_codes4``; compressIntoUint4, Quantizer.h:1305-1327).
"""

from __future__ import annotations

import numpy as np
import torch

from ngt_tpu_torch.quant.clustering import kmeans_dev

_F32 = torch.float32


def encode_dev(x: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """x [N, D] f32, codebooks [M, K, dsub] -> codes [N, M] uint8: per
    subspace the nearest centroid, the first on ties (the reference's
    ``_encode``: |x|^2 - 2 x.c + |c|^2)."""
    m, _, dsub = codebooks.shape
    xs = x.reshape(x.shape[0], m, dsub).transpose(0, 1)          # [M, N, dsub]
    dot = torch.bmm(xs, codebooks.transpose(1, 2))
    d2 = (xs * xs).sum(-1)[:, :, None] - 2.0 * dot + (codebooks * codebooks).sum(-1)[:, None, :]
    return torch.argmin(d2, dim=2).to(torch.uint8).T


def lut_dev(q: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """q [B, D'] (D' >= M * dsub) -> LUT [B, M, K] of squared subvector
    distances."""
    m, _, dsub = codebooks.shape
    qs = q[:, : m * dsub].reshape(q.shape[0], m, dsub)
    diff = qs[:, :, None, :] - codebooks[None]
    return (diff * diff).sum(-1)


def pack_codes4(codes: np.ndarray) -> np.ndarray:
    """[N, M] uint8 codes < 16 -> [N, ceil(M/2)] uint8, the low nibble the
    even subspace."""
    n, m = codes.shape
    if m % 2:
        codes = np.concatenate([codes, np.zeros((n, 1), np.uint8)], axis=1)
    return (codes[:, 0::2] | (codes[:, 1::2] << 4)).astype(np.uint8)


def unpack_codes4(packed: np.ndarray, m: int) -> np.ndarray:
    """Inverse of ``pack_codes4``."""
    out = np.empty((packed.shape[0], packed.shape[1] * 2), np.uint8)
    out[:, 0::2] = packed & 0x0F
    out[:, 1::2] = packed >> 4
    return out[:, :m]


def pack_codes4_dev(codes: torch.Tensor) -> torch.Tensor:
    """``pack_codes4`` of a device tensor with an even subspace count."""
    return codes[:, 0::2] | (codes[:, 1::2] << 4)


def _adc(lut_flat: torch.Tensor, codes: torch.Tensor, k: int) -> torch.Tensor:
    """lut_flat [B, M*k], codes [B, E, M] (any int dtype) -> [B, E]: the sum
    over M of each code's table entry."""
    b, e, m = codes.shape
    offs = torch.arange(m, device=codes.device) * k
    idx = (codes.to(torch.int64) + offs).reshape(b, e * m)
    return lut_flat.gather(1, idx).view(b, e, m).sum(-1)


def make_packed_scorer(m: int, k: int):
    """Scorer over PACKED 4-bit codes with the ``graph_search`` scorer
    signature ``(lut_flat [B, M*K], packed [B, E, ceil(M/2)]) -> [B, E]``:
    unpack two nibbles per byte, then the table sum (m subspaces of k
    entries; the low nibble is the even subspace).  Its ``kind`` names
    what it computes, so a graph search may key a captured graph on it."""

    def adc_packed(lut_flat, packed):
        b, e, mp = packed.shape
        codes = torch.stack([packed & 0x0F, packed >> 4], dim=3).view(b, e, 2 * mp)
        return _adc(lut_flat, codes[:, :, :m], k)

    adc_packed.kind = ("pq4", m, k)
    return adc_packed


def adc_gathered(lut_flat: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """PQ scorer over unpacked codes [B, E, M] uint8 with the graph_search
    scorer signature: approximate squared distances [B, E]."""
    return _adc(lut_flat, codes, lut_flat.shape[1] // codes.shape[2])


class ProductQuantizer:
    """M = dimension / dsub codebooks of ksub centroids each over the
    (mean-centered) vectors, held on ``device``."""

    def __init__(self, dimension: int, dsub: int = 2, ksub: int = 16, device="cuda"):
        if dimension % dsub:
            raise ValueError("dimension must be divisible by dsub")
        self.dimension = dimension
        self.dsub = int(dsub)
        self.m = dimension // dsub
        self.ksub = int(ksub)
        self.device = torch.device(device)
        self.codebooks: np.ndarray | None = None   # [M, ksub, dsub]
        self.mean: np.ndarray | None = None        # [D] global centroid

    def _cb(self) -> torch.Tensor:
        return torch.tensor(np.asarray(self.codebooks, np.float32), device=self.device)

    def fit(self, x: np.ndarray, iters: int = 20, seed: int = 0,
            center: bool = True) -> "ProductQuantizer":
        """k-means++ codebooks over the rows of x (less their mean when
        ``center``), in chunks of subspaces whose rows hold about 2^25
        values (one chunk at d = 128 from 2^18 rows), chunk s seeded
        ``seed + s``."""
        x = np.asarray(x, np.float32)[:, : self.dimension]
        self.mean = x.mean(axis=0) if center else np.zeros(self.dimension, np.float32)
        resid = torch.from_numpy(np.ascontiguousarray(x - self.mean)).to(self.device)
        xs = resid.view(len(x), self.m, self.dsub).transpose(0, 1)
        step = max(1, (1 << 25) // max(len(x) * self.dsub, 1))
        parts = [
            kmeans_dev(xs[s : s + step], self.ksub, iters, "kmeans++", seed + s)[0]
            for s in range(0, self.m, step)
        ]
        self.codebooks = torch.cat(parts).cpu().numpy()
        return self

    def encode(self, x: np.ndarray) -> np.ndarray:
        """[N, D] -> codes [N, M] uint8."""
        x = np.asarray(x, np.float32)[:, : self.dimension] - self.mean
        xt = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        return encode_dev(xt, self._cb()).cpu().numpy()

    def decode(self, codes: np.ndarray) -> np.ndarray:
        out = self.codebooks[np.arange(self.m)[None, :], codes.astype(np.int64)]
        return out.reshape(len(codes), self.dimension) + self.mean

    def lut(self, queries) -> torch.Tensor:
        """[B, D] -> LUT [B, M, K] on the device."""
        q = np.asarray(queries, np.float32)[:, : self.dimension] - self.mean
        return lut_dev(torch.from_numpy(np.ascontiguousarray(q)).to(self.device), self._cb())

    def state_dict(self) -> dict:
        return {
            "codebooks": self.codebooks,
            "mean": self.mean,
            "dsub": self.dsub,
            "ksub": self.ksub,
            "dimension": self.dimension,
        }

    @classmethod
    def from_state(cls, st: dict, device="cuda") -> "ProductQuantizer":
        pq = cls(int(st["dimension"]), int(st["dsub"]), int(st["ksub"]), device=device)
        pq.codebooks = np.asarray(st["codebooks"], np.float32)
        pq.mean = np.asarray(st["mean"], np.float32)
        return pq
