"""Shared set-up for the ``test_torch_*`` parity tests: one set of tiny
VL-T5 weights and inputs, made from seeds, handed to the JAX package and
to its PyTorch port as numpy arrays."""

import numpy as np

from vqacl_tpu.utils.config import tiny_model_config as jax_tiny


def jax_tiny_params(seed=0, **overrides):
    """(JAX ModelConfig, a JAX parameter pytree as numpy) for the tiny
    config. The values come from a numpy generator, which is much
    quicker on the CPU than compiling JAX's init;
    test_torch_slice.py::test_param_tree_matches_jax_init pins that the
    tree has JAX init's keys, shapes and dtypes."""
    from vqacl_tpu_torch.models.vlt5 import _init_numpy

    cfg = jax_tiny(**overrides)
    return cfg, _init_numpy(np.random.default_rng(seed), cfg)


def torch_cfg_like(jcfg, **overrides):
    """The port's ModelConfig with the same sizes as a JAX one."""
    from vqacl_tpu_torch.utils.config import ModelConfig

    fields = ModelConfig.__dataclass_fields__
    kw = {k: getattr(jcfg, k) for k in fields if k != "fused_attention"}
    kw.update(overrides)
    return ModelConfig(**kw)


def encoder_inputs(cfg, B, seed=0):
    """input_ids [B,L] with ragged padding, vis_feats, boxes (numpy)."""
    rng = np.random.default_rng(seed)
    L, N = cfg.max_text_length, cfg.n_boxes
    ids = rng.integers(3, min(cfg.vocab_size, 32000) - 200,
                       size=(B, L)).astype(np.int32)
    for b in range(B):
        n = int(rng.integers(2, L + 1))
        ids[b, n - 1] = 1                 # EOS
        ids[b, n:] = 0                    # pad
    feats = rng.normal(size=(B, N, cfg.feat_dim)).astype(np.float32)
    x1y1 = rng.uniform(0, 0.5, size=(B, N, 2))
    boxes = np.concatenate([x1y1, x1y1 + rng.uniform(0.1, 0.5, (B, N, 2))],
                           axis=2).clip(0, 1).astype(np.float32)
    return ids, feats, boxes


def proto_banks(cfg, seed=0):
    """Non-zero prototype banks, so retrieval picks different rows."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(cfg.n_ques_types, cfg.d_model)).astype(np.float32),
            rng.normal(size=(cfg.n_categories, cfg.d_model)).astype(np.float32))


def record_trainer(trainer):
    """Per-step losses (replay steps tagged) and batches, every predict's
    answers and every eval step's tokens."""
    rec = {"losses": [], "batches": [], "answers": [], "tokens": []}

    def steps(make, tag):
        def wrapped(*a):
            fn = make(*a)

            def step(state, batch):
                # the stored DER logits come from each package's own
                # forward: compared within a tolerance below
                rec["batches"].append({k: np.asarray(v).tobytes()
                                       for k, v in batch.items()
                                       if k != "der_logits"})
                state, m = fn(state, batch)
                rec["losses"].append((tag, float(m["loss"])))
                return state, m
            return step
        return wrapped

    trainer._train_step = steps(trainer._train_step, "train")
    trainer._der_replay_step = steps(trainer._der_replay_step, "der")
    predict = trainer.predict

    def predicting(loader):
        out = predict(loader)
        rec["answers"].append(dict(out))
        return out

    trainer.predict = predicting
    eval_step = trainer.eval_step

    def evaluating(*a):
        tokens = eval_step(*a)
        rec["tokens"].append(np.asarray(tokens.cpu() if hasattr(tokens, "cpu")
                                        else tokens))
        return tokens

    trainer.eval_step = evaluating
    return rec


# ---- the detector and the 3D ResNeXt at reduced depth ---------------------

# one block per stage, narrow bottlenecks; C4 stays 1024 and res5 2048 so
# the RPN and the heads keep their widths
SMALL_R101 = [("res2", 1, 32, 8, 1), ("res3", 1, 64, 8, 2),
              ("res4", 1, 1024, 16, 2)]
SMALL_RES5 = ("res5", 1, 2048, 16, 2)
# block 0 of each stage with a projection, a second block with identity
SMALL_R3D = [(1, 32, 1), (2, 64, 2)]


def patch_small_stages(monkeypatch):
    """Both packages' stage tables → the reduced ones above."""
    from vqacl_tpu.vision import resnet as jr
    from vqacl_tpu.vision import resnext3d as jx
    from vqacl_tpu_torch.vision import resnet as tr
    from vqacl_tpu_torch.vision import resnext3d as tx

    for m in (jr, tr):
        monkeypatch.setattr(m, "R101_STAGES", SMALL_R101)
        monkeypatch.setattr(m, "RES5", SMALL_RES5)
    for m in (jx, tx):
        monkeypatch.setattr(m, "R3D101_STAGES", SMALL_R3D)


def _perturb_bn(tree, rng):
    """Folded-BN scales in [0.5, 1.5) and biases N(0, 0.1), in place, so
    the affine is exercised (init leaves them 1 and 0)."""
    import torch

    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            _perturb_bn(v, rng)
        elif k == "scale" and "w" in tree:
            tree[k] = torch.from_numpy(
                rng.uniform(0.5, 1.5, v.shape).astype(np.float32))
        elif k == "bias" and "w" in tree:
            tree[k] = torch.from_numpy(
                rng.normal(0, 0.1, v.shape).astype(np.float32))


def small_detector(seed=0, cls_scale=1.0, obj_scale=1.0, delta_scale=1.0):
    """(the port's detector on the CPU, the same weights as the JAX
    package's tree of numpy arrays) at the patched stage tables. The
    class head, the RPN objectness and the RPN deltas are drawn
    ``cls_scale``, ``obj_scale`` and ``delta_scale`` times the init's
    scale: a larger objectness and a spread of class scores put the
    scores far apart compared with f32 noise, so the selected indices
    are well defined, and smaller deltas keep proposals on the image."""
    from vqacl_tpu_torch.vision import frcnn
    from vqacl_tpu_torch.vision.convert_weights import to_jax_params

    p = frcnn.init_frcnn(seed, device="cpu")
    _perturb_bn(p["backbone"], np.random.default_rng(seed))
    p["heads"]["cls_w"] *= cls_scale
    p["rpn"]["obj_w"] *= obj_scale
    p["rpn"]["delta_w"] *= delta_scale
    return p, to_jax_params(p)


def small_resnext3d(seed=0):
    """(the port's 3D ResNeXt on the CPU, the JAX tree as numpy) at
    ``SMALL_R3D``."""
    from vqacl_tpu_torch.vision import resnext3d
    from vqacl_tpu_torch.vision.convert_weights import to_jax_params

    p = resnext3d.init_resnext3d(seed, stages=SMALL_R3D, device="cpu")
    _perturb_bn(p, np.random.default_rng(seed + 1))
    return p, to_jax_params(p)
