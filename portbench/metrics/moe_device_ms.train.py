"""Device time of the kernels launched inside the MoE layers: the span
``moe`` (each layer, open over its backward too) and the forward's
sub-spans inside it (``moe.router``, ``moe.dispatch``, ``moe.experts``,
``moe.shared``, ``moe.combine``), in ms a train or replay step, from the
pair run with the program's recorder on (``profiling.attribute`` gives
each kernel to its innermost span, so the layer is their sum)."""


def read(rec, cell):
    dev = rec.get("span_device_s")
    if dev is None or not rec.get("span_steps"):
        return None
    t = sum(v for k, v in dev.items() if k == "moe" or k.startswith("moe."))
    return 1e3 * t / rec["span_steps"] if t > 0 else None
