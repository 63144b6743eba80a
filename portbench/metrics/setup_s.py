"""Process start to the first timed operation, compilation, loading
and warm-up included (host clock)."""


def read(rec, cell):
    return rec.get("setup_s")
