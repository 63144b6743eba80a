"""1 − the device's busy time per step ÷ the window's time per step, in
%. The busy time is the union of the kernel, copy and fill intervals of
the device-only traced sub-window over its steps: the device's work per
step does not depend on the host's pace, but the profiler slows the
host's side of a step (1.15–1.57× on an H100 80GB HBM3), so the traced
sub-window's own wall would read the device idler than the window ran
it."""


def read(rec, cell):
    t = rec.get("trace")
    if t is None or not rec.get("trace_steps") or not rec.get("steps"):
        return None
    step_s = rec["window_s"] / rec["steps"]
    return 100.0 * (1.0 - t.busy_s / rec["trace_steps"] / step_s)
