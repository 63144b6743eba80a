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
