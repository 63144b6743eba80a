"""K1' and K2, the encoder attention's training forward and backward:
their least time from the shapes ÷ their device time in the traced
sub-window, in %."""

from portbench.roofline.share import share


def read(rec, cell):
    b = cell.config["train"]["batch_size"]
    return share(rec, cell, {"encoder_attention.fwd_train": b,
                             "encoder_attention.bwd": b})
