"""Device ms a batch of the level path's kernels (profiled stretch): the
level in one launch (the level layout of the fit kernel), R1 and R1b of a
remap level, the order statistic (#2), and the phase kernels and sweeps
that stand in above the card's gate."""

PATTERNS = [
    r"pw_fit_level_kernel<(true|false), true>",
    r"pw_r1b?_kernel",
    r"pw_os_",
    r"pw_(remap_nodes|remap_points|early_outs|plane_table|split|finish)_kernel",
    r"pw_(stats_points|stats_finish|def_step|seed_kernel)",
    r"pw_(apply|m2)_kernel",
]


def read(run):
    if run.trace is None or run.traced_calls == 0:
        return None
    seconds, rows = run.trace.seconds_matching(PATTERNS)
    return 1e3 * seconds / run.traced_calls if rows else None
