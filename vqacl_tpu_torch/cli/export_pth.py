"""Export a port ``.npz`` checkpoint as a reference-loadable ``.pth``.

Counterpart of ``vqacl_tpu/cli/export_pth.py``: the parameters of a
checkpoint written by either package (``train/checkpoint.py``'s format)
become a torch ``state_dict`` with the reference's key naming
(``models/hf_import.py::to_state_dict``), so a model trained here loads
back into the reference stack.

Prototype banks live inside the ``.npz`` but have no reference
state-dict key (the reference never saves them): they are skipped here;
use the ``Q/V_prototype.npy`` files the trainer writes beside its
checkpoints.

Usage:
    python -m vqacl_tpu_torch.cli.export_pth <snap>/q_recognition_LAST.npz out.pth
"""

from __future__ import annotations

import argparse

from vqacl_tpu_torch.models.hf_import import save_reference_pth
from vqacl_tpu_torch.train.checkpoint import load_checkpoint


class _ShapeCfg:
    """``to_state_dict`` reads only the layer counts: taken off the tree."""

    def __init__(self, params) -> None:
        self.num_layers = sum(
            1 for k in params["encoder"] if k.startswith("block_"))
        self.num_decoder_layers = sum(
            1 for k in params["decoder"] if k.startswith("block_"))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="port .npz checkpoint -> reference .pth")
    ap.add_argument("checkpoint", help="path to {task}_LAST[.npz]")
    ap.add_argument("out", help="output .pth path")
    a = ap.parse_args(argv)

    params, proto, step = load_checkpoint(a.checkpoint)
    cfg = _ShapeCfg(params)
    save_reference_pth(params, a.out, cfg)
    if any(float(b.abs().sum()) > 0 for b in (proto.q_proto, proto.v_proto)):
        print("note: checkpoint contains non-empty prototype banks — "
              "NOT carried into the .pth (the reference never saves "
              "them in state_dict); use the Q/V_prototype.npy files "
              "the trainer writes alongside checkpoints")
    print(f"wrote {a.out} (step {step}, enc {cfg.num_layers} / "
          f"dec {cfg.num_decoder_layers} layers)")


if __name__ == "__main__":
    main()
