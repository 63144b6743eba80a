"""Model FLOPs of the window's rows (``flops.train_qa``: forward +
backward, no recompute) ÷ the window ÷ the bf16 dense peak of one H100
SXM (989 TFLOP/s), in %."""

PEAK = 989e12


def read(rec, cell):
    if "rows" not in rec:
        return None
    return 100.0 * rec["flops"] / rec["window_s"] / PEAK
