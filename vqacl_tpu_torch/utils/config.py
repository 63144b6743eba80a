"""Run configuration for the serving, training and continual-learning
paths and the training entry points.

Counterpart of ``vqacl_tpu/utils/config.py``: every field that
``cli/args.py::parse_config`` writes, with the JAX package's defaults
(the same t5-base geometry, optimisation hyperparameters and CL
protocol). ``fused_attention`` is a boolean here: the CLI maps its
``auto|on|off`` onto it. The yaml round-trip (``Config.save``/``load``)
imports ``yaml`` inside the methods, so the module itself needs nothing
beyond the standard library. Block recompute is the ``remat`` argument
of ``make_train_step``; the CL trainer passes ``MeshConfig.remat``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict


@dataclass
class ModelConfig:
    """Architecture hyperparameters: VL-T5 (t5-base defaults) or, with
    ``arch="moonlight"``, VL-Moonlight."""

    vocab_size: int = 32200          # 32100 sentencepiece+extra ids + 100 vis ids
    d_model: int = 768
    d_kv: int = 64
    num_heads: int = 12
    d_ff: int = 3072
    num_layers: int = 12             # encoder layers
    num_decoder_layers: int = 12
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    dropout_rate: float = 0.1
    layer_norm_epsilon: float = 1e-6
    feed_forward_proj: str = "relu"  # t5-base v1.0 uses ReLU
    tie_word_embeddings: bool = True
    pad_token_id: int = 0
    eos_token_id: int = 1
    decoder_start_token_id: int = 0

    # --- visual embedding ---
    feat_dim: int = 2048             # Faster-RCNN region feature dim
    pos_dim: int = 4                 # (x1,y1,x2,y2); +1 area appended in-model
    n_images: int = 2                # img_order embedding table size
    use_vis_order_embedding: bool = True
    use_vis_layer_norm: bool = True
    individual_vis_layer_norm: bool = True

    # --- sequence geometry ---
    max_text_length: int = 20
    n_boxes: int = 36
    gen_max_length: int = 20         # HF generate() default max_length
    target_max_length: int = 10      # answer token budget

    # --- prototype mechanism ---
    n_ques_types: int = 10           # Q prototype bank rows
    n_categories: int = 80           # V prototype bank rows (COCO)
    use_prototype: bool = True

    # Encoder attention through ops/fused_attention.py (the CUDA kernel
    # on CUDA tensors, its plain version on CPU tensors). False runs the
    # unfused path with the full [1,H,S,S] bias, kept as the reference
    # the kernel path is compared with.
    fused_attention: bool = True
    # The teacher-forced decoder's causal self-attention and its cross-
    # attention through the same kernels. It takes effect only together
    # with fused_attention; off by default, as in the JAX package.
    fused_decoder: bool = False
    # merged q/k/v (self) and k/v (cross) projection GEMMs
    # (t5.qkv_proj_merged; the fused kernels take q, k and v as strided
    # views of the one output). "auto" → True on one device
    # (resolve_merged_qkv, called by the CL trainer); readers take only a
    # strict True, so "auto" elsewhere keeps the separate projections, as
    # in JAX. A regrouping of the same products: the parameter layout is
    # unchanged.
    merged_qkv: object = "auto"
    # fold ALL decoder layers' cross-attention K/V projections (their
    # input, the encoder states, is the same for every layer) into ONE
    # [D, n·2·H·dk] GEMM (t5.cross_kv_fold_all): the unfused decoder
    # stack and the decode's cross-K/V precompute. Off by default, as in
    # JAX (an opt-in for decoders deep relative to batch·S).
    folded_cross_kv: bool = False

    # --- the backbone: "vlt5" (models/vlt5.py, the fields above) or
    # "moonlight" (models/moonlight.py: Moonlight-16B-A3B's decoder-only
    # MLA + MoE language model after the visual embedding). The fields
    # below are read by "moonlight" alone, under the names of its HF
    # config; it also reads d_model, num_heads, vocab_size,
    # layer_norm_epsilon (its RMSNorm eps) and the geometry fields.
    arch: str = "vlt5"
    num_hidden_layers: int = 27
    first_k_dense_replace: int = 1   # leading dense layers
    intermediate_size: int = 11264   # the dense layers' SwiGLU width
    moe_intermediate_size: int = 1408
    router_experts: int = 64         # the router's outputs (n_routed_experts)
    experts_held: int = 64           # routed experts held here: ids 0..n-1
    num_experts_per_tok: int = 6
    n_shared_experts: int = 2        # one SwiGLU of n x moe width
    routed_scaling_factor: float = 2.446
    norm_topk_prob: bool = True
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 50000.0
    router_bias_gamma: float = 1e-3  # the selection bias's update speed
    seq_aux_alpha: float = 1e-4      # the sequence-wise balance loss weight

    @property
    def encoder_len(self) -> int:
        return self.max_text_length + self.n_boxes


_MODEL_FIELDS = [f.name for f in dataclasses.fields(ModelConfig)]
# arch and the fields after it: read by arch "moonlight" alone
MOONLIGHT_FIELDS = tuple(_MODEL_FIELDS[_MODEL_FIELDS.index("arch"):])


@dataclass
class TrainConfig:
    """Optimisation hyperparameters (the JAX package's defaults)."""

    lr: float = 1e-4
    warmup_ratio: float = 0.1
    weight_decay: float = 0.01
    adam_eps: float = 1e-6
    adam_dtype: str = "bfloat16"     # Adam moment storage; arithmetic is f32
    adam_impl: str = "hf"            # "hf": HF AdamW direction (ε on the
                                     # uncorrected √v, correction in the step
                                     # size); "torch": m̂/(√v̂+ε)
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    clip_grad_norm: float = 5.0
    grad_accum: int = 1              # equal microbatches per optimizer step
    batch_size: int = 80
    valid_batch_size: int = 100
    schedule: str = "constant_warmup"   # or "linear_warmup"
    freeze: bool = False             # train only the shared embedding
    from_scratch: bool = True        # False: the CLI starts from --backbone
    proto_alpha: float = 0.5         # Q memory-bank EMA coefficient
    proto_beta: float = 0.3          # V bank EMA coefficient
    lambda_Q: float = 0.01           # memory-loss weights
    lambda_V: float = 0.1
    lambda_Q_new: float = 0.0
    lambda_V_new: float = 0.0
    use_memory_loss: bool = False
    # --- the continual-learning loop (cl/trainer.py) ---
    epochs: int = 3
    seed: int = 66666                # group order, exemplars, dropout
    memory: bool = True              # experience replay on
    m_size: int = 5000               # replay buffer size M
    comp_cate: str = "G-1"           # held-out category group ("G-1" = none)
    use_class_hierarchy: bool = True  # dual-level inner loop over G1..G5
    # "none" | "ewc" | "mas" (cl/regularizers.py) | "der" | "derpp"
    # (train/step.py::make_der_replay_step)
    cl_reg: str = "none"
    reg_lambda: float = 1.0          # penalty weight λ (EWC/MAS) / α (DER)
    fisher_batches: int = 40         # importance-estimation batches/task
    der_beta: float = 0.5            # DER++ CE weight β (derpp only)


@dataclass
class MeshConfig:
    """Placement over the ranks, one process per card (parallel/mesh.py):
    the CLIs build the mesh with ``make_mesh(dp, tp, pp)`` (dp -1 taking
    every rank ``torchrun`` started that tp·pp leaves), and the trainer
    refuses sizes other than its mesh's. ``tp``: Megatron tensor
    parallelism of the blocks; ``pp``: GPipe stages of each stack over
    ``pp_micro`` microbatches of a rank's rows (parallel/pipeline.py).
    ``param_layout`` "replicated" keeps the whole parameters and Adam
    moments on every rank; "tp" each rank's Megatron slices
    (parallel/sharding.py::TpLayout); "fsdp" each rank's slice of every
    leaf of at least 2^14 elements (``fsdp_rules``; composed with the tp
    slices at tp > 1; the step gathers them before its forward).
    ``remat`` is the train steps' block recompute (False, True/"full",
    "dots"; not applied in the pipelined stacks); ``dtype`` the compute
    dtype the CLI hands the trainer; ``param_dtype`` is read by nothing
    yet."""

    dp: int = -1                     # -1: every rank of the mesh
    tp: int = 1                      # tensor-parallel ranks
    pp: int = 1                      # pipeline stages
    pp_micro: int = 4                # pipeline microbatches per step
    dtype: str = "bfloat16"          # compute dtype (the CLI's --dtype)
    param_dtype: str = "float32"     # master weights
    remat: object = False
    param_layout: str = "replicated"


@dataclass
class DataConfig:
    """Loader policy. ``device_cache`` keeps the whole region-feature
    table on the device (data/device_cache.py) in ``device_cache_dtype``
    ("bfloat16", "float32" or "int8"); batches then carry int32 slots.
    ``device_cache_sharded`` row-shards the table over the dp ranks (each
    holds 1/dp of it; a lookup combines the rows in one all_reduce)."""

    dataset_root: str = "datasets"
    feature_files: Dict[str, str] = field(default_factory=dict)
    train_split: str = "karpathy_train"
    valid_split: str = "karpathy_val"
    test_split: str = "karpathy_test"
    n_workers: int = 4               # loader threads per BatchLoader
    train_topk: int = -1             # first k items of each train split
    valid_topk: int = -1             # ... of each val and test split
    answer_normalize: bool = False
    host_cache_bytes: int = 4 << 30  # host-RAM tier of the feature cache
    device_cache: bool = False
    device_cache_sharded: bool = False
    device_cache_dtype: str = "bfloat16"   # bfloat16|float32|int8


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    data: DataConfig = field(default_factory=DataConfig)
    output: str = "snap/vqacl"
    backbone: str = "t5-base"
    verbose: bool = True

    # ---- yaml round-trip, as the JAX package's ----
    def to_dict(self) -> Dict[str, Any]:
        """The fields as nested dicts; a VL-T5 configuration leaves out
        ``arch`` and the fields only VL-Moonlight reads, so that the JAX
        package reads the file (they load back at their defaults)."""
        out = dataclasses.asdict(self)
        if self.model.arch == "vlt5":
            for name in MOONLIGHT_FIELDS:
                out["model"].pop(name)
        return out

    def save(self, path: str) -> None:
        import yaml

        with open(path, "w") as f:
            yaml.safe_dump(self.to_dict(), f, sort_keys=False)

    @classmethod
    def load(cls, path: str) -> "Config":
        import yaml

        with open(path) as f:
            raw = yaml.safe_load(f)
        return cls.from_dict(raw)

    @classmethod
    def from_dict(cls, raw: Dict[str, Any]) -> "Config":
        kw: Dict[str, Any] = {}
        for f_ in dataclasses.fields(cls):
            if f_.name not in raw:
                continue
            v = raw[f_.name]
            sub = {"model": ModelConfig, "train": TrainConfig,
                   "mesh": MeshConfig, "data": DataConfig}.get(f_.name)
            kw[f_.name] = sub(**v) if sub is not None and isinstance(v, dict) \
                else v
        return cls(**kw)


def resolve_merged_qkv(model_cfg: ModelConfig, n_devices: int = 1) -> None:
    """Resolve ``merged_qkv="auto"`` in place from the mesh's world size
    ``n_devices``: True on one device, False on more (the part of JAX's
    ``resolve_fused_attention`` that applies to the port, config.py:282-
    283), whatever the mesh's shape. ``fused_attention`` is not resolved
    here: the CLI's "auto" is True on the card at any mesh, each rank
    running K1/K1′/K2 on its rows and, under tp, its heads (JAX's
    explicit ``fused_attention=True`` shard_map path; its "auto" would
    turn the kernels off on a mesh, and its pp stacks run the einsum
    attention — ROADMAP §3)."""
    if model_cfg.merged_qkv == "auto":
        model_cfg.merged_qkv = n_devices == 1


def tiny_model_config(**overrides) -> ModelConfig:
    """A scaled-down architecture for tests (same code path, tiny shapes);
    the same sizes as ``vqacl_tpu.utils.config.tiny_model_config``."""
    base = dict(
        vocab_size=256, d_model=32, d_kv=8, num_heads=4, d_ff=64,
        num_layers=2, num_decoder_layers=2, relative_attention_num_buckets=8,
        relative_attention_max_distance=16, feat_dim=16, max_text_length=6,
        n_boxes=4, gen_max_length=6, target_max_length=5,
        n_ques_types=10, n_categories=80,
    )
    base.update(overrides)
    return ModelConfig(**base)
