"""Device time of the kernels launched inside the ``mla`` spans (each
attention's forward and, through the span's backward marks, its
backward), in ms a train or replay step, from the pair run with the
program's recorder on (``profiling.attribute``)."""


def read(rec, cell):
    dev = rec.get("span_device_s")
    if dev is None or not rec.get("span_steps"):
        return None
    t = dev.get("mla", 0.0)
    return 1e3 * t / rec["span_steps"] if t > 0 else None
