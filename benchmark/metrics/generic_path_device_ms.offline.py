"""Device ms a batch of the generic path's kernels (profiled stretch): the
fit in one launch (the fit layout of the fit kernel, #5), the sweep plan
and the segment ops over it (#6 planned, #7, #8), the order statistic
(#2), the segment sort (torch's radix sort and histogram) and the sweeps
that stand in above the card's gate."""

PATTERNS = [
    r"pw_fit_level_kernel<(true|false), false>",
    r"pw_plan_",
    r"pw_seg_sum_planned_kernel",
    r"pw_gather_kernel",
    r"pw_minmax_kernel",
    r"pw_run_sum_kernel",
    r"pw_os_",
    r"RadixSort",
    r"kernelHistogram1D",
    r"pw_(apply|m2)_kernel",
]


def read(run):
    if run.trace is None or run.traced_calls == 0:
        return None
    seconds, rows = run.trace.seconds_matching(PATTERNS)
    return 1e3 * seconds / run.traced_calls if rows else None
