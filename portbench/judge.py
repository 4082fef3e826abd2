"""How ``correct`` is decided: the program's answers held to the plain
reference (``reference/match.py``), after the window has closed and the
program's state is freed.

The configuration states exact answers, so every number compared is a
count of answers that differ from the reference's, and every limit is 0.
Over the window's first request and those sampled from the seed (one in
``check_every``): ``wrong_rows``, rows whose best offset or score differs
(over all rows, or over the rows a filtered query verified);
``wrong_hits``, threshold hits missing or extra; ``unchecked``, 1 when
the sample holds no request.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from portbench.reference import match as ref

Checks = Dict[str, Tuple[float, float]]


@dataclass
class Answer:
    """What one request returned, as the check reads it."""

    best_locs: np.ndarray
    best_scores: np.ndarray
    hits: Optional[np.ndarray] = None
    survivor_rows: Optional[np.ndarray] = None

    @classmethod
    def of(cls, res) -> "Answer":
        return cls(np.asarray(res.best_locs), np.asarray(res.best_scores),
                   None if res.hits is None else np.asarray(res.hits),
                   None if res.survivor_rows is None
                   else np.asarray(res.survivor_rows))


def request_masks(reqs, ids: Sequence[int]) -> np.ndarray:
    out = []
    for i in ids:
        r = reqs.get(i)
        out.append(r["masks"] if r["masks"] is not None
                   else ref.as_masks(r["codes"][None])[0])
    return np.stack(out)


def differing(got_locs, got_scores, locs, scores) -> int:
    if np.shape(got_locs) != np.shape(locs) or \
            np.shape(got_scores) != np.shape(scores):
        return max(len(locs), len(got_locs))
    return int(((np.asarray(got_locs) != locs)
                | (np.asarray(got_scores) != scores)).sum())


def hit_set(h: Optional[np.ndarray]) -> set:
    return set() if h is None else {tuple(int(x) for x in r) for r in h}


def reference_answers(frags: torch.Tensor, traffic: dict,
                      masks: np.ndarray, survivors: List[Optional[np.ndarray]],
                      skip: Optional[Sequence[int]] = None) -> List[Answer]:
    """The reference's answer to each request (``skip``: the control)."""
    k = masks.shape[0]
    hits: List[Optional[np.ndarray]] = [None] * k
    if traffic["reduction"] == "threshold":
        hits = ref.hits(frags, masks, [traffic["threshold"]] * k, skip=skip)
    full = [j for j in range(k) if survivors[j] is None]
    out: List[Optional[Answer]] = [None] * k
    if full:
        locs, scores = ref.best(frags, masks[full], skip=skip)
        for n, j in enumerate(full):
            out[j] = Answer(locs[:, n], scores[:, n], hits[j])
    for j in range(k):
        if survivors[j] is not None:
            locs, scores = ref.best(frags, masks[j:j + 1], skip=skip,
                                    rows=survivors[j])
            out[j] = Answer(locs[:, 0], scores[:, 0], hits[j], survivors[j])
    return out


def check(run, out: dict) -> Checks:
    answers: Dict[int, Answer] = out["answers"]
    ids = sorted(answers)
    wrong_rows = wrong_hits = 0
    if ids:
        frags = torch.from_numpy(out["frags"]).to(run.device)
        masks = request_masks(out["reqs"], ids)
        want = reference_answers(
            frags, run.cell.traffic, masks,
            [answers[i].survivor_rows for i in ids])
        for i, w in zip(ids, want):
            a = answers[i]
            wrong_rows += differing(a.best_locs, a.best_scores,
                                    w.best_locs, w.best_scores)
            if w.hits is not None:
                wrong_hits += len(hit_set(a.hits) ^ hit_set(w.hits))
    checks: Checks = {"wrong_rows": (wrong_rows, 0),
                      "unchecked": (int(not ids), 0)}
    if run.cell.traffic["reduction"] == "threshold":
        checks["wrong_hits"] = (wrong_hits, 0)
    return checks
