"""Device kernels in the traced sub-window ÷ the train and replay steps
it ran."""


def read(rec, cell):
    if "trace" not in rec or not rec.get("trace_steps"):
        return None
    return rec["trace"].launches / rec["trace_steps"]
