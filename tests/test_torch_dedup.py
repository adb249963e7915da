"""The port's deduplicating insert (``Index.batch_insert_dedup``) and the
``progress`` callback of ``build_anng`` against the JAX package's, on the
CPU, on the same numpy inputs.

The rows are integers, so every distance is exact in float32 in both
packages and ``(ids, identical, dist)`` must be equal, not close, along
with the rows each package inserted:

* near-duplicates of stored rows beside new rows;
* chains inside a batch (a row within the radius of an earlier row that
  was itself deduplicated is compared with inserted rows only);
* a saturated window: more than 16 earlier rows within the radius, none of
  them inserted, so the top-16 window is full and the exact re-check finds
  an inserted row behind it;
* tied distances: two equal stored rows and a row equidistant from two
  inserted batch rows (the lower id and the lower row win).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import ngt_tpu
import ngt_tpu_torch

DIM = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _unit(v: float) -> np.ndarray:
    out = np.zeros(DIM, np.float32)
    out[0] = v
    return out


def near_duplicates():
    rng = np.random.default_rng(3)
    store = rng.integers(0, 64, size=(256, DIM)).astype(np.float32)
    picks = rng.choice(256, 12, replace=False)
    noise = np.zeros((12, DIM), np.float32)
    noise[np.arange(12), rng.integers(0, DIM, 12)] = rng.choice([-1.0, 1.0], 12)
    fresh = rng.integers(0, 64, size=(12, DIM)).astype(np.float32) + 200
    batch = np.concatenate([store[picks] + noise, fresh])[rng.permutation(24)]
    return store, batch, 1.5


def chains():
    """a; a1 dup of a; a2 within radius of a1 only (inserted); a3 within
    radius of a2 (dup of a2); a4 a copy of a3 (dup of a2, not of a3)."""
    rows = [_unit(v) for v in (0.0, 9.0, 18.0, 27.0, 27.0, 40.0)]
    return None, np.stack(rows), 10.0


def saturated_window():
    """Stored s at 0.  Y at 17 is inserted; 20 rows at 8 are copies of s
    (none inserted); X at 12 has those 20 within the radius (4), so its
    top-16 window is full of rows that were not inserted, and only the
    exact re-check finds Y (5) behind them."""
    rows = [_unit(17.0)] + [_unit(8.0)] * 20 + [_unit(12.0)]
    return np.stack([_unit(0.0), _unit(100.0)]), np.stack(rows), 10.0


def ties():
    """Two equal stored rows (the lower id wins); a row equidistant from
    two inserted batch rows (the lower row wins); a row equidistant from a
    stored row and an inserted batch row (the stored row: the batch row is
    taken only when strictly nearer)."""
    store = np.stack([_unit(0.0), _unit(0.0), _unit(50.0)])
    rows = [_unit(2.0), _unit(20.0), _unit(26.0), _unit(23.0), _unit(58.0), _unit(54.0)]
    return store, np.stack(rows), 4.0


CASES = {"near duplicates": near_duplicates, "chains": chains,
         "saturated window": saturated_window, "ties": ties}


@pytest.mark.parametrize("name", list(CASES))
def test_dedup_matches_jax(name):
    store, batch, radius = CASES[name]()
    out = {}
    for pkg, make in (("jax", lambda: ngt_tpu.create(None, dimension=DIM)),
                      ("torch", lambda: ngt_tpu_torch.create(None, dimension=DIM,
                                                             device="cpu"))):
        idx = make()
        if store is not None:
            idx.batch_insert(store, build=True)
        res = idx.batch_insert_dedup(batch, radius=radius)
        n = idx.store.repository_size
        out[pkg] = (*res, idx.store._x[:n], idx.store._valid[:n], len(idx))
    for got, want in zip(out["torch"], out["jax"]):
        np.testing.assert_array_equal(got, want)
    ids, identical, dist = out["torch"][:3]
    assert identical.any() and (~identical).any()
    assert (dist[identical] <= radius).all() and (dist[~identical] == 0).all()
    if name == "saturated window":
        assert identical[-1] and ids[-1] == ids[0] and dist[-1] == 5.0


def test_build_anng_progress_matches_jax():
    """``progress(done, total)`` after each batch past the bootstrap, with
    the same counts in both packages."""
    from ngt_tpu.graph import build as JB
    from ngt_tpu_torch.graph import build as TB

    data = np.random.default_rng(9).normal(size=(700, DIM)).astype(np.float32)
    calls = {}
    for pkg, make, build in (
        ("jax", lambda: ngt_tpu.create(None, dimension=DIM, device_batch_size=128),
         JB.build_anng),
        ("torch", lambda: ngt_tpu_torch.create(None, dimension=DIM, device_batch_size=128,
                                               device="cpu"), TB.build_anng),
    ):
        idx = make()
        pending = idx.store.batch_insert(data).astype(np.int32)
        idx.graph.ensure_capacity(idx.store._x.shape[0])
        got = []
        build(idx.store, idx.graph, idx.seeder, idx.prop, pending, None,
              progress=lambda done, total: got.append((done, total)))
        calls[pkg] = got
    assert calls["torch"] == calls["jax"]
    assert calls["torch"][-1] == (700, 700) and len(calls["torch"]) == 5
