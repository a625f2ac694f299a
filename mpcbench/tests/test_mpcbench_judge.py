"""The comparison's arithmetic."""

import numpy as np
import torch

from mpcbench import judge
from mpcbench.reference.check import tf32


def test_plan_gap_scales_each_variable():
    Z = np.zeros((31, 7))
    Z[:, 2] = np.linspace(0, 20, 31)
    Zp = Z.copy()
    Zp[5, 2] += 0.021
    assert np.isclose(judge.plan_gap(Zp, Z), 0.021 / 21.0)
    Zp[3, 0] = np.nan
    assert judge.plan_gap(Zp, Z) == float("inf")


def test_param_gap():
    P = np.full((31, 5), 100.0)
    Pp = P.copy()
    Pp[0, 0] += 0.0101
    assert np.isclose(judge.param_gap(Pp, P), 0.0101 / 101.0)


def test_dual_gap():
    lam = np.zeros((31, 10))
    lam[3, 4] = 9.0
    other = lam.copy()
    other[3, 4] = 9.5
    assert np.isclose(judge.dual_gap(other, lam), 0.5 / 10.0)
    other[0, 0] = np.inf
    assert judge.dual_gap(other, lam) == float("inf")


def _port(sel, ok, Z, success=True, lam=None):
    rec = {"success": success, "P": np.zeros((3, 2)), "plan": Z[sel], "batch_Z": Z,
           "batch_ok": np.array(ok), "selected": sel}
    if lam is not None:
        rec["batch_lam"] = lam
    return rec


def _ref(Z, ok, pobj, cold=None, adopt=None, near=None, selected=None, lam=None):
    B = len(ok)
    lam = np.zeros(Z.shape[:2] + (4,)) if lam is None else lam
    br = {"warm_Z": Z, "warm_ok": np.array(ok), "warm_pobj": np.array(pobj, float),
          "warm_lam": lam, "cold_Z": None, "cold_ok": None, "cold_pobj": None, "cold_lam": None,
          "adopt": np.zeros(B, bool) if adopt is None else np.array(adopt),
          "near": np.zeros(B, bool) if near is None else np.array(near),
          "consistency": np.ones(B), "braking": np.zeros(B, bool)}
    if cold is not None:
        br["cold_Z"], br["cold_ok"], br["cold_pobj"], br["cold_lam"] = cold + (lam,)
    return {"success": any(ok), "P": np.zeros((3, 2)), "branches": br, "selected": selected}


def test_the_kept_plan_is_held_against_the_cheapest_or_a_tie():
    Z = np.random.default_rng(0).normal(size=(5, 31, 7))
    ref = _ref(Z, [True] * 5, [3.0, 2.0, 2.0000001, 5.0, 9.0])
    assert judge.corridor_solves(_port(1, [True] * 5, Z), ref, 1e-3) == ([0.0] * 6,
                                                                          (False, 0.0, 0.0))
    gaps, selection = judge.corridor_solves(_port(2, [True] * 5, Z), ref, 1e-3)
    assert gaps[-1] == 0.0 and selection == (False, 0.0, 0.0)
    gaps, selection = judge.corridor_solves(_port(3, [True] * 5, Z), ref, 1e-3)
    assert gaps[-1] > 0.1 and selection == (True, 0.0, 0.0)
    gaps, _ = judge.corridor_solves(_port(1, [True, False, True, True, True], Z), ref, 1e-3)
    assert gaps[1] == float("inf") and gaps[0] == 0.0
    gaps, selection = judge.corridor_solves(_port(1, [True] * 5, Z, success=False), ref, 1e-3)
    assert gaps[-1] == float("inf") and selection is None


def test_carried_duals_are_part_of_a_solves_gap():
    Z = np.random.default_rng(4).normal(size=(2, 31, 7))
    lam = np.abs(np.random.default_rng(5).normal(size=(2, 31, 4)))
    ref = _ref(Z, [True, True], [1.0, 2.0], lam=lam)
    gaps, _ = judge.corridor_solves(_port(0, [True, True], Z, lam=lam), ref, 1e-3)
    assert gaps == [0.0, 0.0, 0.0]
    moved = lam.copy()
    moved[1, 7, 2] += 0.3
    gaps, _ = judge.corridor_solves(_port(0, [True, True], Z, lam=moved), ref, 1e-3)
    assert gaps[0] == 0.0 and gaps[1] > 0.01


def test_an_element_near_a_threshold_may_take_the_other_branch():
    Z = np.random.default_rng(1).normal(size=(3, 31, 7))
    Zc = Z + 0.5
    cold = (Zc, np.array([True, True, True]), np.array([1.0, 1.0, 1.0]))
    port = _port(0, [True] * 3, np.stack([Zc[0], Z[1], Zc[2]]))
    far = _ref(Z, [True] * 3, [1.0, 2.0, 3.0], cold=cold)
    near = _ref(Z, [True] * 3, [1.0, 2.0, 3.0], cold=cold, near=[True, False, True])
    assert max(judge.corridor_solves(port, far, 1e-3)[0][:3]) > 0.1
    assert judge.corridor_solves(port, near, 1e-3)[0][:3] == [0.0, 0.0, 0.0]


def test_fleet_robots_are_judged_one_by_one():
    Z = np.random.default_rng(2).normal(size=(2, 31, 7))
    ref = _ref(Z, [True, False], [1.0, 1.0])
    assert judge.fleet_solves(Z, np.array([1, 1]), ref) == [0.0, float("inf")]
    gaps = judge.fleet_solves(Z + 0.1, np.array([1, -1]), ref)
    assert gaps[0] > 0.01 and gaps[1] is None  # both failed: nothing to compare


def test_sensitivity_and_undecided_solves():
    Z = np.random.default_rng(3).normal(size=(3, 31, 7))
    ref = _ref(Z, [True] * 3, [1.0, 2.0, 3.0], selected=0)
    probe = _ref(np.stack([Z[0], Z[1] + 1e-3, Z[2]]), [True, True, False], [1.0, 2.0, 3.0],
                 selected=0)
    sens = judge.corridor_sensitivities(ref, probe)
    assert sens[0] == 0.0 and sens[1] > 1e-5 and sens[2] == float("inf") and sens[3] == sens[2]


LIMITS = {"param_gap": 1e-5, "wrong_share": 0.25, "solve_tol": 3e-5, "decide_sensitivity": 1e-5,
          "spread_factor": 10, "selection_mismatches": 0}


def test_the_share_counts_every_decided_solve_over_the_tolerance():
    c = judge.Checked()
    c.params = [1e-8]
    c.add_cycle([1e-7, 2e-7, 0.5, 1e-7, float("inf"), None], [0.0, 1e-6, 1.0, 1e-6, 1e-6, 0.0])
    numbers, wrong, beside = judge.verdict(c, LIMITS)
    # 0.5 undecided; inf decided; None (both failed) not compared
    assert numbers["wrong_share"] == 1 / 4 and wrong == 0
    assert beside == {"gap_max": float("inf"), "success_mismatches": 1, "decided": 4,
                      "undecided": 1}
    c.add_cycle([1e-3, 1e-7], [0.0, 0.0])
    numbers, wrong, _ = judge.verdict(c, LIMITS)
    assert numbers["wrong_share"] == 2 / 6 and wrong == 2


def test_an_answer_far_outside_the_references_spread_stays_decided():
    c = judge.Checked()
    c.add_cycle([1.3, 0.05, 1e-7], [4e-4, 0.01, 1e-3])
    assert c.decided(LIMITS) == [True, False, False]
    numbers, wrong, _ = judge.verdict(c, LIMITS)
    assert numbers["wrong_share"] == 1.0 and wrong == 1


def test_half_of_a_batch_wrong_fails_whatever_the_median():
    c = judge.Checked()
    c.add_cycle([1e-7] * 30 + [0.2] * 18, [0.0] * 48)
    numbers, wrong, _ = judge.verdict(c, dict(LIMITS))
    assert numbers["wrong_share"] == 18 / 48 and wrong == 18


def test_a_selection_is_judged_where_both_planners_agree():
    c = judge.Checked()
    c.add_cycle([1e-7] * 6, [0.0] * 6, (True, 1e-7, 1e-7))  # another planner, costs apart
    c.add_cycle([1e-7] * 6, [1.0] * 6, (True, 1e-7, 1e-7))  # the same, the solves undecided
    c.add_cycle([1e-7] * 6, [0.0] * 6, (False, 1e-7, 1e-7))  # a tie
    c.add_cycle([1e-7] * 6, [0.0] * 6, (True, 1e-7, 0.3))  # the cheapest planner disagrees
    numbers, wrong, _ = judge.verdict(c, LIMITS)
    assert numbers["selection_mismatches"] == 2 and wrong >= 2


def test_a_parameter_gap_over_its_limit_is_wrong():
    c = judge.Checked()
    c.params = [1e-8, 1e-4]
    c.add_cycle([1e-7], [0.0])
    numbers, wrong, _ = judge.verdict(c, {k: v for k, v in LIMITS.items()
                                          if k != "selection_mismatches"})
    assert numbers == {"param_gap": 1e-4, "wrong_share": 0.0} and wrong == 1


def test_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-12, 1.0 + 3 * 2**-12, -3.14159265], dtype=torch.float64)
    y = tf32(x)
    assert y[0] == 1.0 + 2**-10 and y[1] == 1.0 and y[2] == 1.0 + 2**-10
    assert abs(y[3] - x[3]) <= 2**-11 * 4
