"""The comparison that decides `correct`: the program's answers against the
frozen reference's, each compared number against its limit.

A checked answer (a corridor cycle, a fleet solve of the sampled robots)
gives:
- its parameter gap: the parameter blocks, max |P - P_ref| / (1 + |P_ref|);
- one row per solve: its gap, the larger of the plan's (per variable
  max_k |Z - Z_ref| / (1 + max_k |Z_ref|)) and the carried duals' (max |lam
  - lam_ref| / (1 + max |lam_ref|)); infinite where the solve's success
  differs from the reference's, and None (both failed, nothing to compare)
  where neither succeeded. A T-MPC++ cycle has one row per planner and one
  for the plan it kept, held against the reference's cheapest planner (or
  the program's pick, where their weighted costs are within `tie`);
- and whether the reference decides the solve: the reference probes every
  solve (again, from inputs moved by a few float32 roundings). A solve is
  undecided where the reference's answer moves under the probe by more than
  `decide_sensitivity` and by at least 1/`spread_factor` of the program's
  gap, or where its success flips: the fixed-count SQP-RTI is discontinuous
  there, and another rounding of the same algorithm may land where the
  program did. An answer far outside that spread (a step that returned its
  start) stays decided.

Where the reference's escalation or exit decision for a solve lies near its
threshold (within a factor of 10), the solve may match either branch.

Numbers compared:
- `param_gap`: the largest parameter gap of the run.
- `wrong_share`: the share of the decided solves with something to compare
  (not both failed) whose gap is over `solve_tol`, a success mismatch among
  them. Not the largest gap: on a few decided solves of sound runs the
  program's answer still lies far from the reference's (another local
  solution; a success that flips where the probe did not reach), while a
  fault on a part of the batch reads as that part's share.
- `selection_mismatches` (T-MPC++): the cycles in which the program kept
  another planner than the reference's cheapest, where both planners' plans
  agree within `solve_tol` (so both sides' costs agree) and their weighted
  costs differ by more than `tie`.
Reported beside them: the largest gap, the success mismatches, the decided
solves compared and the undecided ones.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

INF = float("inf")


def plan_gap(Z: np.ndarray, Z_ref: np.ndarray) -> float:
    Z, Z_ref = np.asarray(Z, float), np.asarray(Z_ref, float)
    if not np.all(np.isfinite(Z)):
        return INF
    scale = 1.0 + np.abs(Z_ref).max(axis=-2, keepdims=True)
    return float((np.abs(Z - Z_ref) / scale).max())


def dual_gap(lam: np.ndarray, lam_ref: np.ndarray) -> float:
    lam, lam_ref = np.asarray(lam, float), np.asarray(lam_ref, float)
    if not np.all(np.isfinite(lam)):
        return INF
    return float(np.abs(lam - lam_ref).max() / (1.0 + np.abs(lam_ref).max()))


def param_gap(P: np.ndarray, P_ref: np.ndarray) -> float:
    P, P_ref = np.asarray(P, float), np.asarray(P_ref, float)
    if P.shape != P_ref.shape:
        return INF
    return float((np.abs(P - P_ref) / (1.0 + np.abs(P_ref))).max())


def _outcomes(br: dict, b: int):
    """The outcomes of element b that the reference accepts: the one it
    took and, where its escalation or exit decision lay near a threshold,
    the other branch too. Each (plan, success, cost, duals)."""
    adopt = bool(br["adopt"][b])
    names = ["cold" if adopt else "warm"]
    if br["near"][b] and br["cold_Z"] is not None:
        names.append("warm" if adopt else "cold")
    return [(br[f"{n}_Z"][b], bool(br[f"{n}_ok"][b]), float(br[f"{n}_pobj"][b]),
             br[f"{n}_lam"][b]) for n in names]


def match(Z, ok: bool, br: dict, b: int, lam=None):
    """(gap, the matched outcome's success and cost) of the program's
    element b (plan Z, or None where it has none; carried duals `lam`, or
    None where it carries none) against the closest outcome the reference
    accepts; the gap is infinite where no accepted outcome has the
    program's success, and None where both failed."""
    best = None
    for Zr, okr, cost, lamr in _outcomes(br, b):
        if bool(ok) != okr:
            gap = INF
        elif not ok:
            gap = None
        elif Z is None:
            gap = INF
        else:
            gap = plan_gap(Z, Zr)
            if lam is not None:
                gap = max(gap, dual_gap(lam, lamr))
        key = -1.0 if gap is None else gap
        if best is None or key < best[0]:
            best = (key, gap, okr, cost)
    return best[1:]


def sensitivity(br: dict, probe: dict, b: int, duals: bool = True) -> float:
    """How far element b's answer moves under the probe: the plan's gap (and
    the duals', with `duals`), or inf where its success flips."""
    Zr, okr, _, lamr = _outcomes(br, b)[0]
    Zq, okq, _, lamq = _outcomes(probe, b)[0]
    if okr != okq:
        return INF
    if not okr:
        return 0.0
    return max(plan_gap(Zq, Zr), dual_gap(lamq, lamr) if duals else 0.0)


def corridor_elements(rec: dict):
    """(plan or None, success, carried duals or None) of each solve in a
    corridor cycle's record."""
    if "batch_ok" in rec:
        Zs, lams = rec.get("batch_Z"), rec.get("batch_lam")
        return [(None if Zs is None else Zs[b], bool(ok), None if lams is None else lams[b])
                for b, ok in enumerate(rec["batch_ok"])]
    return [(rec.get("plan"), bool(rec["success"]), None)]


def corridor_solves(port: dict, ref: dict, tie: float):
    """(the solve gaps of one checked corridor cycle, its selection or None):
    the selection is (whether the program's kept planner's weighted cost
    exceeds the reference's cheapest by more than `tie`, and the two
    planners' plan gaps)."""
    br = ref.get("branches")
    if br is None:  # the solve never ran (no data ready): success alone
        return [None if port["success"] == ref["success"] else INF], None
    if "consistency" not in br:  # one solve a cycle
        return [match(port.get("plan"), port["success"], br, 0)[0]], None
    n = len(br["adopt"])
    elems = corridor_elements(port)
    if len(elems) != n:  # no batch kept (no planner succeeded): every planner failed
        elems = [(None, False, None)] * n
    gaps, plan_gaps, cost = [], [], np.full(n, INF)
    for b, (Z, ok, lam) in enumerate(elems):
        gap, okr, c = match(Z, ok, br, b, lam)
        gaps.append(gap)
        plan_gaps.append(match(Z, ok, br, b)[0])
        if okr:
            cost[b] = c * br["consistency"][b]
    # The kept plan: the reference's cheapest planner's, or the program's
    # pick where it is tied with the cheapest.
    selection = None
    if not np.isfinite(cost).any():
        gaps.append(None if not port["success"] else INF)
    elif not port["success"]:
        gaps.append(INF)
    else:
        i, least = port["selected"], cost.min()
        j = int(np.argmin(cost))
        distinct = bool(cost[i] > least + tie * max(abs(least), 1e-12))
        selection = (distinct, plan_gaps[i], plan_gaps[j])
        gaps.append(match(port["plan"], True, br, j if distinct else i)[0])
    return gaps, selection


def corridor_sensitivities(ref: dict, probe: dict, duals: bool = True) -> List[float]:
    """How far each solve of a corridor cycle moves under the reference's
    probe; the kept plan's is the largest of the planners', or inf where
    the probe keeps another planner."""
    br, pb = ref.get("branches"), probe.get("branches")
    if br is None:
        return [0.0]
    n = len(br["adopt"]) + ("consistency" in br)
    if pb is None:  # the probe's cycle ran no solve
        return [INF] * n
    sens = [sensitivity(br, pb, b, duals) for b in range(len(br["adopt"]))]
    if "consistency" in br:
        sens.append(max(sens) if probe.get("selected") == ref.get("selected") else INF)
    return sens


def fleet_solves(Z, codes, ref: dict, lam=None) -> List[Optional[float]]:
    """The solve gaps of a checked fleet solve, one per sampled robot."""
    return [match(Z[b], codes[b] == 1, ref["branches"], b,
                  None if lam is None else lam[b])[0] for b in range(len(codes))]


def fleet_sensitivities(ref: dict, probe: dict, duals: bool = True) -> List[float]:
    return [sensitivity(ref["branches"], probe["branches"], b, duals)
            for b in range(len(ref["branches"]["adopt"]))]


class Checked:
    """The checked answers of a run: the parameter gaps, one row per solve
    (its gap and its sensitivity under the reference's probe), and the
    T-MPC++ selections (corridor_solves)."""

    def __init__(self):
        self.params: List[float] = []
        self.gaps: List[Optional[float]] = []
        self.sens: List[float] = []
        self.selections: List[tuple] = []

    def add_cycle(self, gaps, sens, selection=None):
        self.gaps.extend(gaps)
        self.sens.extend(sens)
        if selection is not None:
            self.selections.append(selection)

    def decided(self, limits: dict) -> List[bool]:
        return [s <= limits["decide_sensitivity"] or s * limits["spread_factor"] < (g or 0.0)
                for g, s in zip(self.gaps, self.sens)]


def verdict(checked: Checked, limits: Dict[str, float]):
    """(the compared numbers, the count of wrong answers, the numbers
    reported beside them)."""
    tol = limits["solve_tol"]
    decided = checked.decided(limits)
    rows = [g for g, d in zip(checked.gaps, decided) if d and g is not None]
    over = sum(g > tol for g in rows)
    numbers = {"param_gap": max(checked.params, default=0.0),
               "wrong_share": over / len(rows) if rows else 0.0}
    if "selection_mismatches" in limits:
        numbers["selection_mismatches"] = sum(
            distinct and gi is not None and gj is not None and gi <= tol and gj <= tol
            for distinct, gi, gj in checked.selections)
    wrong = sum(p > limits["param_gap"] for p in checked.params)
    if numbers["wrong_share"] > limits["wrong_share"]:
        wrong += over
    wrong += numbers.get("selection_mismatches", 0)
    compared = [g for g in checked.gaps if g is not None]
    beside = {"gap_max": max(compared, default=0.0),
              "success_mismatches": sum(g == INF for g in compared),
              "decided": len(rows), "undecided": decided.count(False)}
    return numbers, wrong, beside


def compared_names(limits: dict) -> List[str]:
    return [k for k in ("param_gap", "wrong_share", "selection_mismatches") if k in limits]


def checks_record(numbers: Dict[str, float], limits: Dict[str, float],
                  extra: Optional[Dict[str, float]] = None) -> Dict[str, dict]:
    rec = {k: {"value": numbers[k], "limit": limits[k]} for k in compared_names(limits)}
    for k, v in (extra or {}).items():
        rec[k] = {"value": v, "limit": 0}
    return rec
