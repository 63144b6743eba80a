"""vqacl_tpu_torch — the PyTorch/CUDA port of ``vqacl_tpu`` for one NVIDIA H100.

Module names mirror ``vqacl_tpu`` so each counterpart is easy to find.
The package imports ``torch`` and ``numpy`` only: nothing of JAX and
nothing of ``vqacl_tpu``. Parameters are plain nested dicts of tensors
with the same keys as the JAX pytree (``models/convert.py`` bridges the
two). Entry points run on ``device="cuda"`` unless the caller passes
another device; on a CPU tensor every kernel wrapper takes its plain
PyTorch version, on a CUDA tensor it launches the hand-written kernel.

Ported so far: the serving path, ``serve.VQAPredictor``/``VQAServer``
→ ``train.step.make_eval_step`` → ``models.vlt5.encode`` (the encoder
attention runs in ``csrc/fused_attention_fwd.cu``) → prototype retrieval
→ ``models.generate.greedy_decode``; and the training step,
``train.step.make_train_step`` → ``models.vlt5.forward_train`` (the
encoder attention's forward and backward in ``csrc/fused_attention_fwd.cu``
and ``csrc/fused_attention_bwd.cu``) → backward → ``train.optim``, with
the decoder's attention in the same kernels (``fused_decoder``) and block
recompute (``remat``); the ``mm_bench`` probe with its weight-gradient
kernel ``csrc/dw_splitk.cu`` (``ops.dw``); and the continual-learning
loop, ``cl.trainer.VQACLTrainer``/``cl.comp_trainer.CompVQACLTrainer``
over ``data.partition``'s group loaders and ``data.synthetic_module``,
with the EWC/MAS (``cl.regularizers``) and DER/DER++ step options; and
the serving extras: ``models.generate.beam_search``, the device feature
cache ``data.device_cache`` (serving and the loop), the HTTP front end
``cli.serve_http`` and the host feature stores (``data.features``' h5
store, ``data.packed_cache`` over the host C++ ``native/``); the model
extensions (merged projections, the classifier head, weight import and
export, VL-BART); and the training entry points, ``cli.vqacl_train`` and
``cli.nextqa_train`` (argv through ``cli.args``) over the reference-format
``data.vqa_module`` and ``nextqa.data``, with WUPS evaluation
(``evaluation.wups``) and the feature converters (``data.tsv_convert``,
``data.arrow_store``); and region and video feature extraction,
``cli.extract_features``/``cli.extract_video_features`` over
``vision.frcnn`` (ResNet-101-C4, the RPN, RoIAlign, the 36-box NMS
sweep; the greedy suppressions in ``csrc/nms.cu``), ``vision.resnext3d``
and ``vision.video``, with ``vision.convert_weights`` and
``cli.validate_features``; and data parallelism, multihost and FSDP,
``parallel.mesh.make_mesh`` (a ``torch.distributed`` process group,
one rank per card) with ``parallel.multihost`` and ``parallel.sharding``,
wired through the CL trainer, the train steps and both training CLIs
(``torchrun ... --mesh_dp N``), the kernels drawing each rank's dropout
rows by a Philox row offset; and the protocol scripts, ``ablation`` (the
Table-1 surrogate) and ``soak`` (the ten-task protocol at t5-base).
"""

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy top-level API, as ``vqacl_tpu``'s: ``make_mesh``."""
    if name == "make_mesh":
        from vqacl_tpu_torch.parallel.mesh import make_mesh
        return make_mesh
    raise AttributeError(f"module 'vqacl_tpu_torch' has no attribute "
                         f"{name!r}")
