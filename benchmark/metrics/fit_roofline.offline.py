"""The fit's share of its roofline, in %: the least time of the plane-fit
work the algorithm needs on the profiled scans, over the device time of
the fit kernels in the profiled stretch.

The work is counted by the benchmark's reference (``reference.FitWork``),
the same whatever implements it, with the operations a point needs in the
reference's arithmetic (``reference/patchwork.py``):

- a fit iteration's distance pass over the node's points: the centred
  point (3 subtractions), the dot with the normal (3 multiplies, 2 adds),
  the absolute value, the threshold compare and the convergence compare:
  11;
- a plane fit over its points: the mean (3 adds), the centred rows (3
  subtractions), the covariance's 6 distinct products and their sums
  (12): 18;
- the final fit's residual: the dot (5), the absolute value and the sum:
  7;
- bytes: each scan's points read once (12 bytes) and its ground mask
  written once (1 byte), per level its recursion reached.

The least time is the larger of operations / the card's float32 peak and
bytes / its memory bandwidth (``arith.PEAKS``).  The fit kernels: the fit
in one launch in both layouts (in the level layout it also runs the
level's other phases, so the share reads low there), and the sweeps that
stand in for it above the card's gate.
"""

import sys

from benchmark import arith

PATTERNS = [r"pw_fit_level_kernel<", r"pw_(apply|m2)_kernel"]
DIST_FLOPS = 11
FIT_FLOPS = 18
RESID_FLOPS = 7
BYTES_PER_LEVEL_POINT = 13


def read(run):
    if run.trace is None or run.work is None:
        return None
    seconds, rows = run.trace.seconds_matching(PATTERNS)
    if not rows:
        return None
    w = run.work
    flops = (DIST_FLOPS * w.dist_points + FIT_FLOPS * w.fit_points
             + RESID_FLOPS * w.resid_points)
    nbytes = BYTES_PER_LEVEL_POINT * w.level_points
    card = run.card.get("name", "")
    least = arith.least_seconds(flops, nbytes, card)
    if least is None:
        return None
    print(f"# fit_roofline.offline: {flops} flops, {nbytes} bytes over "
          f"{w.scans} scans; least {least[0]} s by {least[1]}; fit kernels "
          f"{seconds} s; {card}, power limit "
          f"{run.card.get('power_limit', 'unknown')}", file=sys.stderr)
    return arith.roofline_pct(flops, nbytes, seconds, card)
