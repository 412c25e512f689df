"""The comparison that decides `correct`: one `run_fl` result of the timed
window against the plain reference's run of the same config and seed.

Numbers compared, each against its limit in the cell's file (a cell
compares the numbers its file gives limits for):

* ``first_loss_gap``: the relative gap of round 1's loss: the forward
  pass on the initial parameters and the data;
* ``second_loss_gap``: the relative gap of round 2's loss, taken on the
  parameters that round 1's local SGD (forward, backward, update) and
  its refresh and aggregation made. Round 1 is the plan's first state,
  in which every edge is strong;
* ``loss_rel_gap``: the largest relative gap of a round's loss over the
  reference's first ``check_rounds`` rounds. From round 3 on a loss is
  taken on parameters that a round with weak edges aggregated, whose
  buffers must hold their stale rows. Training at lr 0.05 amplifies
  rounding round by round (two sound fp32 runs drift apart by 1e-4
  within six rounds and by a few per cent by round 20), so the
  reference follows the first three;
* ``sim_gap_ms``: the largest gap of the simulated clock, every round's
  cycle time and the run's mean and total, over all the run's rounds
  (the same float operations on both sides: exact).

A missing round reads as an infinite gap. The evaluations, every
``eval_every`` rounds, lie past the rounds the reference follows: a
window call's accuracies are only checked to be there and in [0, 1].
"""

from __future__ import annotations

import math

NUMBERS = ("first_loss_gap", "second_loss_gap", "loss_rel_gap",
           "sim_gap_ms")


def _max_gap(pairs, rel=False) -> float:
    gap = 0.0
    for a, b in pairs:
        d = abs(a - b) / abs(b) if rel else abs(a - b)
        if not math.isfinite(d):
            return math.inf
        gap = max(gap, d)
    return gap


def compare(res, ref, check_rounds: int) -> dict:
    """Numbers of ``res`` (an `FLResult`) against ``ref`` (a
    `reference.fl.Run` of ``check_rounds`` rounds)."""
    losses = list(res.round_losses)
    out = {}
    out["loss_rel_gap"] = (
        _max_gap(zip(losses[:check_rounds], ref.round_losses), rel=True)
        if len(losses) >= check_rounds == len(ref.round_losses)
        else math.inf)
    for i, key in enumerate(("first_loss_gap", "second_loss_gap")):
        out[key] = (_max_gap([(losses[i], ref.round_losses[i])], rel=True)
                    if len(losses) > i and len(ref.round_losses) > i
                    else math.inf)
    cyc = list(res.cycle_times_ms)
    out["sim_gap_ms"] = (
        _max_gap(list(zip(cyc, ref.cycle_times_ms))
                 + [(res.mean_cycle_ms, ref.mean_cycle_ms),
                    (res.total_time_s * 1e3, ref.total_time_s * 1e3)])
        if len(cyc) == len(ref.cycle_times_ms) else math.inf)
    return out


def well_formed(res, rounds: int, eval_every: int) -> bool:
    """A window call's result has every round's loss, finite, an
    evaluation every ``eval_every`` rounds and after the last, each an
    accuracy in [0, 1], and every round's simulated time."""
    want = list(range(eval_every, rounds + 1, eval_every))
    if rounds % eval_every:
        want.append(rounds)
    return (len(res.round_losses) == rounds
            and all(math.isfinite(x) for x in res.round_losses)
            and list(res.eval_rounds) == want
            and all(0.0 <= a <= 1.0 for a in res.eval_accs)
            and len(res.cycle_times_ms) == rounds)


def judge(numbers: dict, limits: dict) -> bool:
    """Every number the cell gives a limit for is within it."""
    return all(numbers[k] <= v for k, v in limits.items())
