"""The plain reference that decides ``correct``.

VL-T5 (T5 v1.0 encoder-decoder with region or clip features, Cho et al.
2021) in plain PyTorch: forward and backward by autograd, the prototype
EMA and retrieval, and HF AdamW. It computes in float32 with TF32 off
(``precision.F32``) or, as the control, with every product's operands
rounded to scaled fp8 e4m3 (``precision.FP8``). It keeps the storage
types the configuration states (the bf16 feature table, bf16 Adam
moments) and makes its own inputs: tokens (``inputs.encode``), batches
from the benchmark's raw items and feature table, and dropout masks from
the same generator streams the configuration's seed starts (``philox``
for the attention dropout). It imports nothing of the port.
"""
