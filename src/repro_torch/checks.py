"""Comparisons that hold a result on the card against the CPU: the
tolerance rule for float32 results, the two rules for bf16 results, the bound
two float segment sums of the same terms keep, and a top-k compared
allowing for ties. ``chip_smoke.py`` and the tests use them; no serving
path does."""

from __future__ import annotations

import math

import torch


def _as_list(x) -> list:
    return x if isinstance(x, list) else [x]


def _dist(xs: list, ys: list) -> float:
    """The largest |x - y| over the pairs, in float64 on each x's device (a
    pair on the card is compared there)."""
    return max(float((x.detach().double() - y.detach().to(x.device).double()).abs().max())
               if x.numel() else 0.0 for x, y in zip(xs, ys))


def tolerance(cpu, f64) -> tuple[float, float]:
    """(tol, ulp) for holding the card against the CPU, for one compared
    quantity (a tensor or a list of them, such as a parameter tree's leaves):
    twice the CPU float32 route's distance from a float64 evaluation of the
    same weights and inputs, and at least 4 float32 units in the last place
    (``ulp``) of the largest float64 magnitude. A route as accurate as the
    CPU's is within twice its distance of it."""
    cpu, f64 = _as_list(cpu), _as_list(f64)
    noise = max(float((a.detach().double() - b).abs().max()) for a, b in zip(cpu, f64))
    top = max(float(b.abs().max()) for b in f64)
    ulp = 2.0 ** (math.floor(math.log2(top)) - 23) if top > 0 else 2.0 ** -149
    return max(2 * noise, 4 * ulp), ulp


def hold(card, cpu, f64) -> dict:
    """Hold ``card`` (a tensor or a list of them, on any device) against the
    CPU float32 route ``cpu`` and the float64 evaluation ``f64`` within
    ``tolerance(cpu, f64)``. Returns the largest distances (``err``: card
    vs CPU, ``err64``: card vs float64, ``noise``: CPU vs float64), ``tol``
    and ``ulp``; ``ok`` holds both of the card's."""
    card, cpu, f64 = _as_list(card), _as_list(cpu), _as_list(f64)
    tol, ulp = tolerance(cpu, f64)

    err, err64 = _dist(card, cpu), _dist(card, f64)
    return {"ok": err <= tol and err64 <= tol, "err": err, "err64": err64,
            "noise": _dist(cpu, f64), "tol": tol, "ulp": ulp}


def check_topk(vals, idx, ref_scores, tol: float) -> dict:
    """Hold a top-k (``vals``, ``idx``, best first) against reference scores
    (N,) up to ``tol``, allowing for ties. Candidates that score the same
    are common (at 10^6 Zipf candidates one (item, cate) pair recurs many
    times), and top-k routines order ties differently, so the indices are
    not compared rank by rank. Instead:

    - ``value_err``: the values against the reference's top-k values, rank
      by rank;
    - ``index_err``: each returned index scores its value in the reference;
    - ``missing``: candidates above the reference's k-th value by more than
      ``2 tol`` (in every top-k within ``tol``) absent from ``idx``;
    - ``unique``: no index is returned twice.

    ``ok`` holds all four."""
    ref = ref_scores.detach().double().cpu()
    vals, idx = vals.detach().double().cpu(), idx.detach().long().cpu()
    ref_vals = torch.topk(ref, vals.numel()).values
    value_err = float((vals - ref_vals).abs().max()) if vals.numel() else 0.0
    index_err = float((ref[idx] - vals).abs().max()) if vals.numel() else 0.0
    sure = torch.nonzero(ref > ref_vals[-1] + 2 * tol).flatten() if vals.numel() else idx
    missing = int((~torch.isin(sure, idx)).sum())
    unique = idx.unique().numel() == idx.numel()
    return {"ok": value_err <= tol and index_err <= tol and missing == 0 and unique,
            "value_err": value_err, "index_err": index_err, "sure": int(sure.numel()),
            "missing": missing, "unique": unique}


def bf16_ulp(top: float) -> float:
    """The bf16 unit in the last place of a magnitude ``top`` (8 bits of
    significand)."""
    return 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 2.0 ** -133


def hold_bf16(out, ref, f64) -> dict:
    """The bf16 rule: ``out``'s distance from a float64 (or otherwise more
    exact) evaluation ``f64`` is no larger than the reference route's
    (``ref``) distance from it, plus one bf16 ulp of the largest magnitude
    of ``f64``. Each argument is a tensor or a list of them. Returns the
    distances (``err64``: out vs f64, ``ref64``: ref vs f64, ``err``: out
    vs ref), ``ulp`` and ``ok``."""
    out, ref, f64 = _as_list(out), _as_list(ref), _as_list(f64)

    ulp = bf16_ulp(max(float(y.detach().abs().max()) if y.numel() else 0.0 for y in f64))
    err64, ref64 = _dist(out, f64), _dist(ref, f64)
    return {"ok": err64 <= ref64 + ulp, "err64": err64, "ref64": ref64, "err": _dist(out, ref),
            "ulp": ulp}


def hold_bf16_noise(out, ref, f64) -> dict:
    """The LM rule for bf16 results: ``out`` within ``tol`` of the reference
    route ``ref`` and of the more exact evaluation ``f64``, where ``tol`` is
    twice ``ref``'s distance from ``f64`` and at least two bf16 ulps of the
    largest magnitude of ``f64`` (a route as accurate as the reference's is
    within twice its noise of either). Each argument is a tensor or a list
    of them. Returns the distances (``err``: out vs ref, ``err64``: out vs
    f64, ``noise``: ref vs f64), ``tol``, ``ulp`` and ``ok``."""
    out, ref, f64 = _as_list(out), _as_list(ref), _as_list(f64)

    ulp = bf16_ulp(max(float(y.detach().abs().max()) if y.numel() else 0.0 for y in f64))
    noise = _dist(ref, f64)
    tol = max(2 * noise, 2 * ulp)
    err, err64 = _dist(out, ref), _dist(out, f64)
    return {"ok": err <= tol and err64 <= tol, "err": err, "err64": err64, "noise": noise,
            "tol": tol, "ulp": ulp}


def segment_sum_excess(vals: torch.Tensor, ids: torch.Tensor, n: int, got: torch.Tensor,
                       want: torch.Tensor, block: int = 64) -> tuple[float, float]:
    """How far two float segment sums of the same terms (``vals`` (E, F) by
    segment ids ``ids`` into ``n`` rows; ``got`` and ``want`` (n, F)) lie
    outside the bound that any two float32 summation orders keep: a sum of
    d terms taken in float32 in any order is within gamma sum|v| of the
    exact sum, gamma = k / (1 - k), k = (d - 1) 2^-24, so two are within twice that; each rounding to bf16 adds
    half a bf16 ulp of its value. The largest excess of |got - want| over
    that bound (<= 0 where the two agree as well as float32 sums can) and
    the largest |got - want|. Computed in float64, ``block`` columns at a
    time."""
    vals = vals.flatten(1) if vals.dim() > 1 else vals[:, None]
    got, want = got.reshape(n, vals.shape[1]), want.reshape(n, vals.shape[1])
    d = torch.zeros(n, dtype=torch.float64, device=vals.device).index_add_(
        0, ids, torch.ones(ids.shape[0], dtype=torch.float64, device=vals.device))
    excess, err = -math.inf, 0.0
    for c in range(0, vals.shape[1], block):
        s = torch.zeros((n, min(block, vals.shape[1] - c)), dtype=torch.float64,
                        device=vals.device).index_add_(0, ids, vals[:, c:c + block].double().abs())
        a, b = got[:, c:c + block].double(), want[:, c:c + block].double()
        k = (d[:, None] - 1).clamp_min(0) * 2.0 ** -24
        tol = 2 * k / (1 - k) * s
        if got.dtype == torch.bfloat16:
            top = torch.maximum(a.abs(), b.abs())
            tol = tol + torch.where(top > 0, torch.exp2(torch.floor(torch.log2(top)) - 7), 0.0)
        if a.numel():
            diff = (a - b).abs()
            excess, err = max(excess, float((diff - tol).max())), max(err, float(diff.max()))
    return excess, err
