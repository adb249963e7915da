"""The comparison that decides ``correct``: every answer of the window
against the plain reference (``reference.py``), after the program's state
is freed.  ``judges/<kind>.py`` computes the readings of a traffic kind;
those the cell's file gives a limit decide.  A window with no answer reads
every limit's number as infinite."""

from __future__ import annotations

import numpy as np

#: answers judged per block of the distance recomputation
BLOCK = 8192


def checks(readings: dict, limits: dict) -> dict:
    """The readings that the cell holds to a limit (cells/<cell>.json)."""
    return {name: {"value": float(readings[name]), "limit": float(limit)}
            for name, limit in limits.items()}


def width(a: np.ndarray, k: int, fill) -> np.ndarray:
    """An answer cut or padded to k columns (a short answer reads as missing
    ids)."""
    a = np.asarray(a)
    if a.shape[1] >= k:
        return a[:, :k]
    return np.concatenate([a, np.full((a.shape[0], k - a.shape[1]), fill, a.dtype)], 1)


def judge(kind_judge, requests, base, queries, sample, config, limits, device) -> dict:
    """``kind_judge`` is the ``judge`` of ``judges/<kind>.py``."""
    answers = [r.answer for r in requests if r.answer is not None]
    if not answers:
        return {"readings": {}, "checks": checks(dict.fromkeys(limits, float("inf")), limits)}
    return kind_judge(answers, base, queries, sample, config, limits, device)
