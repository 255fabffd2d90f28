"""Frames whose result reached the benchmark's sink before the next frame
was due on the sensor's schedule, per cent of the frames due in the window,
open loop, host clock: the live node keeps up with its sensor.  A frame
with no result misses."""


def read(run):
    if run.due is None or len(run.due) < 2:
        return None
    period = run.due[1] - run.due[0]
    met = sum(1 for k, d in enumerate(run.due)
              if k in run.arrived and run.arrived[k] - d < period)
    return 100.0 * met / len(run.due)
