"""Run a function on N ranks over gloo on the CPU, for the port's
data-parallel tests.

``spawn(fn, n, tmp_path, **kw)`` starts N processes (the ``spawn``
start method), each of which joins a process group through a file store
under ``tmp_path`` (no TCP port, so parallel test workers cannot
collide), builds its ``MeshContext`` with ``make_mesh(dp=n,
device="cpu", init_method=...)`` (or, with ``mesh={"tp": 2, ...}``,
those axes and dp taking the rest) and calls ``fn(ctx, **kw)``. Each
rank's return value comes back through a file, in rank order. A rank
that raises fails the call with its traceback; ranks still running after
``timeout`` seconds are killed and fail it, so a deadlock fails a test
and never hangs the suite.

The workers below import torch and the port only (no JAX), so a rank
starts in a few seconds; the tests hold their results against the
one-process port and JAX.
"""

import os
import pickle
import traceback

import numpy as np


def _entry(rank, n, tmp, fn, kw, mesh):
    out = os.path.join(tmp, f"rank{rank}.pkl")
    try:
        import torch
        torch.set_num_threads(1)
        from vqacl_tpu_torch.parallel.mesh import make_mesh

        ctx = make_mesh(**(mesh or {"dp": n}), device="cpu", backend="gloo",
                        init_method=f"file://{os.path.join(tmp, 'store')}",
                        rank=rank, world_size=n, timeout_s=120)
        result = ("ok", fn(ctx, **kw))
    except BaseException:
        result = ("error", traceback.format_exc())
    with open(out, "wb") as f:
        pickle.dump(result, f)
    try:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()
    except BaseException:
        pass


def spawn(fn, n, tmp_path, timeout=240, mesh=None, **kw):
    """[fn(ctx_rank, **kw) for each rank], or AssertionError naming the
    rank that failed, timed out or died. ``mesh``: ``make_mesh``'s axis
    sizes (default ``{"dp": n}``)."""
    import multiprocessing as mp

    tmp = str(tmp_path)
    os.makedirs(tmp, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(r, n, tmp, fn, kw, mesh))
             for r in range(n)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert not hung, f"ranks {hung} still running after {timeout} s"
    results = []
    for r, p in enumerate(procs):
        path = os.path.join(tmp, f"rank{r}.pkl")
        assert os.path.exists(path), f"rank {r} died (exit {p.exitcode})"
        with open(path, "rb") as f:
            status, value = pickle.load(f)
        assert status == "ok", f"rank {r} failed:\n{value}"
        results.append(value)
    return results


def flat_numpy(tree, prefix=""):
    """{'a/b': numpy} of a nested dict of tensors or arrays."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_numpy(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree.detach().cpu() if hasattr(tree, "detach")
                               else tree)}


# ---------------------------------------------------------------------------
# workers (each runs on every rank)
# ---------------------------------------------------------------------------

def w_multihost(ctx, dicts, rows):
    """barrier, all_gather_object and merge_quesid2ans of this rank's
    dict; the mesh's gather_rows (bit for bit: a -0.0 and a NaN payload
    included) and replicate of rank 0's tensors and generator."""
    import torch

    from vqacl_tpu_torch.parallel import multihost as M
    from vqacl_tpu_torch.parallel.mesh import make_mesh, replicate

    M.barrier("test")
    mine = dicts[ctx.rank]
    out = {"count": M.process_count(), "index": M.process_index(),
           "main": M.is_main_process(),
           "gathered": M.all_gather_object(mine),
           "merged": M.merge_quesid2ans(mine)}
    g = ctx.gather_rows(torch.from_numpy(rows[ctx.rank]))
    gen = torch.Generator().manual_seed(100 + ctx.rank)
    tree = replicate(ctx, {"a": torch.full((3,), float(ctx.rank)),
                           "gen": gen})
    out.update(bits=g.view(torch.int32).numpy(),
               replicated=tree["a"].numpy(),
               gen=torch.rand(4, generator=tree["gen"]).numpy())
    errs = {}
    for kw in ({"dp": 3}, {"dp": 1}, {"tp": 2}, {"pp": 2}, {"tp": 3}):
        try:
            m = make_mesh(device="cpu", **kw)
            errs[str(kw)] = (m.dp, m.tp, m.pp, m.dp_index, m.tp_index,
                             m.pp_stage)
        except ValueError as e:
            errs[str(kw)] = str(e)
    out.update(mesh_errors=errs, auto_dp=make_mesh(device="cpu").dp,
               stats=dict(ctx.stats))
    return out


def _nbytes(*trees):
    """Bytes of the tensors of ``trees`` on this rank."""
    from vqacl_tpu_torch.train.optim import tree_leaves

    return sum(x.numel() * x.element_size() for t in trees
               for x in tree_leaves(t))


def _step_state(tc, params, seed=1):
    from vqacl_tpu_torch.models.convert import from_jax_params
    from vqacl_tpu_torch.models.prototype import ProtoState
    from vqacl_tpu_torch.train.optim import make_transform
    from vqacl_tpu_torch.train.state import TrainState

    m = tc.model
    proto = ProtoState.create(m.n_ques_types, m.n_categories, m.d_model,
                              device="cpu")
    return TrainState.create(from_jax_params(params),
                             make_transform(tc.train), proto, seed=seed,
                             warmup_iters=1.0, t_total=40.0)


def run_steps(tc, params, batches, kind, ctx=None, fsdp_layout=False,
              reg_lambda=0.0, tp_layout=False):
    """3 steps of ``kind`` ("train", "der", "ewc", "mas") from the same
    state: per-step metrics, then the final params, proto and (EWC/MAS)
    importance as numpy. With ``ctx``, each rank runs its rows
    (``shard_batch``) on the mesh (the pipelined stacks over its pp group
    in ``tc.mesh.pp_micro`` microbatches when pp > 1); ``fsdp_layout``
    keeps FSDP slices, ``tp_layout`` the rank's tp slices."""
    import torch

    from vqacl_tpu_torch.cl import regularizers as R
    from vqacl_tpu_torch.parallel.mesh import shard_batch
    from vqacl_tpu_torch.parallel.sharding import FsdpLayout
    from vqacl_tpu_torch.train.step import (make_der_replay_step,
                                            make_train_step)

    state = _step_state(tc, params)
    if ctx is not None and ctx.pp > 1:
        tc.model.pp_mesh, tc.model.pp_micro = ctx, int(tc.mesh.pp_micro)
    layout = tpl = None
    if fsdp_layout or tp_layout:
        from vqacl_tpu_torch.parallel.sharding import TpLayout
        from vqacl_tpu_torch.train.optim import make_transform
        if tp_layout:
            tpl = layout = TpLayout(ctx, state.params)
        else:
            layout = FsdpLayout(ctx, state.params)
        state = state._replace(params=layout.shard(state.params))
        state = state._replace(opt_state=make_transform(tc.train).init(
            state.params))
    accum = int(tc.train.grad_accum)
    kw = dict(dtype=torch.float32, device="cpu", mesh_ctx=ctx,
              fsdp=None if tpl is not None else layout, tp=tpl)
    out = {"metrics": []}
    if kind in ("ewc", "mas"):
        step = R.make_importance_step(tc, kind, dtype=torch.float32,
                                      device="cpu", mesh_ctx=ctx)
        acc = R.init_reg_state(state.params).omega
        for b in batches:
            b = shard_batch(ctx, b) if ctx is not None else b
            acc = step(acc, state.params, state.proto, b)
        out["importance"] = flat_numpy(acc)
        # then the penalty step (EWC/MAS anchor), from that importance
        reg = R.consolidate(R.init_reg_state(state.params), state.params,
                            acc, len(batches))
        train = make_train_step(tc, reg_lambda=1.0, **kw)
        step_fn = lambda s, b: train(s, b, reg)  # noqa: E731
    elif kind == "der":
        step_fn = make_der_replay_step(tc, **kw)
    else:
        step_fn = make_train_step(tc, reg_lambda=reg_lambda, **kw)
    for b in batches:
        if ctx is not None:
            b = shard_batch(ctx, b, accum if kind != "der" else 1)
        state, m = step_fn(state, b)
        out["metrics"].append({k: float(v) for k, v in m.items()})
    params = state.params if layout is None else layout.gather(state.params)
    out["params"] = flat_numpy(params)
    out["proto"] = {k: getattr(state.proto, k).numpy()
                    for k in state.proto._fields}
    out["generator"] = state.generator.get_state().numpy()
    if layout is not None and tpl is None:
        out["fsdp_bytes"] = _nbytes(state.params, state.opt_state.mu,
                                    state.opt_state.nu)
        from vqacl_tpu_torch.train.optim import tree_leaves
        mu = tree_leaves(state.opt_state.mu)[0].element_size()
        out["full_bytes"] = sum(x.numel() for x in tree_leaves(params)) \
            * (4 + 2 * mu)               # f32 params and two moments
        out["specs"] = layout.specs
    return out


def w_steps(ctx, cases):
    """``run_steps`` for every case {name: (tc, params, batches, kind,
    fsdp[, tp])} on this rank's mesh."""
    return {name: run_steps(tc, params, batches, kind, ctx=ctx,
                            fsdp_layout=fsdp, tp_layout=bool(tp[:1] and
                                                             tp[0]))
            for name, (tc, params, batches, kind, fsdp, *tp)
            in cases.items()}


def trainer_run(tc, params, data_kw, ctx=None, record=False):
    """A tiny VQACLTrainer run → (result matrix, answers of every predict,
    final params, metrics); ``ctx`` the mesh (None: one process)."""
    import torch

    from vqacl_tpu_torch.cl.trainer import VQACLTrainer
    from vqacl_tpu_torch.data.synthetic_module import SyntheticDataModule
    from vqacl_tpu_torch.data.tokenizer import VLT5Tokenizer
    from vqacl_tpu_torch.models.convert import from_jax_params

    tok = VLT5Tokenizer()
    trainer = VQACLTrainer(tc, SyntheticDataModule(tok, **data_kw), tok,
                           verbose=False, device="cpu",
                           init_params=from_jax_params(params),
                           dtype=torch.float32, mesh_ctx=ctx)
    answers = []
    predict = trainer.predict

    def recording(loader):
        out = predict(loader)
        answers.append(dict(out))
        return out

    trainer.predict = recording
    metrics = trainer.train()
    out = {"matrix": trainer.result_matrix.to_dict(), "answers": answers,
           "metrics": metrics, "losses": list(trainer.step_losses["train"]),
           "params": flat_numpy(trainer._full_params())}
    if trainer._fsdp is not None:
        out["param_bytes"] = _nbytes(trainer.state.params)
    if trainer._cache is not None:
        out["cache_rows"] = trainer._cache.rows
        out["lookup_bytes"] = trainer._cache.lookup_bytes
    return out


def w_trainer(ctx, runs, bad=None, cli_argv=None, cli_tasks=None):
    """``trainer_run`` for each {name: (tc, params, data_kw)}; with
    ``bad`` (tc, params, data_kw), the ValueError of a trainer over it;
    then, with ``cli_argv``, ``cli.vqacl_train.main`` on the same group
    (its data module cut to ``cli_tasks``)."""
    out = {name: trainer_run(tc, params, data_kw, ctx=ctx)
           for name, (tc, params, data_kw) in runs.items()}
    if bad is not None:
        try:
            trainer_run(*bad, ctx=ctx)
            out["bad"] = None
        except ValueError as e:
            out["bad"] = str(e)
    if cli_argv is not None:
        import vqacl_tpu_torch.data.vqa_module as vm
        from vqacl_tpu_torch.cli import vqacl_train

        orig = vm.VQADataModule.__init__

        def cut(self, root, tok, tasks=None, **kw):
            orig(self, root, tok, tasks=cli_tasks, **kw)

        vm.VQADataModule.__init__ = cut
        out["cli"] = vqacl_train.main(cli_argv)
    return out
