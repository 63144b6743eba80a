"""The port's multi-process utilities (``parallel/multihost.py``) and the
mesh's collectives (``parallel/mesh.py``), against the JAX package.

Without a process group every function is the identity, as JAX's one
process. Two ranks over gloo on the CPU (``tests/torch_dp.py``): a
barrier, ``all_gather_object`` in rank order and ``merge_quesid2ans``
equal to JAX's ``merge_quesid2ans`` on the same dicts (JAX's gather
faked as ``tests/test_multihost.py`` fakes it); ``gather_rows`` gives
every rank's rows bit for bit (a -0.0 and a NaN payload survive the
int32-word sum); ``replicate`` gives rank 0's tensors and generator
state on every rank; ``make_mesh`` on a group of two takes dp -1 or 2
and raises, with JAX's message, for another dp or a tp·pp the ranks do
not divide; tp = 2 or pp = 2 over two ranks take JAX's (dp, tp, pp)
order.
"""

import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_dp import spawn, w_multihost  # noqa: E402
from vqacl_tpu_torch.parallel import multihost as TM  # noqa: E402
from vqacl_tpu_torch.parallel.mesh import make_mesh  # noqa: E402

DICTS = [{1001: "yes", 1002: "two", "q3": "left"},
         {2001: "no", 2002: "a dog" * 40, 1002: "three"}]


def _rows():
    rng = np.random.default_rng(0)
    rows = [rng.normal(size=(3, 5)).astype(np.float32) for _ in range(2)]
    rows[0][0, 0] = -0.0
    rows[1][2, 4] = np.array(0x7FC01234, np.uint32).view(np.float32)
    return rows


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return spawn(w_multihost, 2, tmp_path_factory.mktemp("multihost"),
                 dicts=DICTS, rows=_rows())


def _jax_merge(monkeypatch, objs, which):
    """JAX's merge_quesid2ans of objs[which] as process ``which`` of two,
    its process_allgather faked with the other process's payload."""
    import jax
    from jax.experimental import multihost_utils

    from vqacl_tpu.parallel import multihost as JM

    payloads = [np.frombuffer(pickle.dumps(o), np.uint8) for o in objs]
    calls = {"n": 0}

    def fake_allgather(x):
        calls["n"] += 1
        if calls["n"] == 1:
            return np.stack([np.asarray([p.size], np.int64)
                             for p in payloads])
        out = np.zeros((2, max(p.size for p in payloads)), np.uint8)
        for i, p in enumerate(payloads):
            out[i, :p.size] = p
        return out

    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(multihost_utils, "process_allgather", fake_allgather)
    return JM.merge_quesid2ans(objs[which])


def test_identity_without_a_process_group():
    assert TM.process_count() == 1 and TM.process_index() == 0
    assert TM.is_main_process()
    TM.barrier("noop")
    assert TM.all_gather_object(DICTS[0]) == [DICTS[0]]
    assert TM.merge_quesid2ans(DICTS[1]) == DICTS[1]
    ctx = make_mesh(device="cpu")
    assert (ctx.dp, ctx.tp, ctx.pp, ctx.rank, ctx.distributed) == \
        (1, 1, 1, 0, False)
    x = torch.arange(6.0).view(3, 2)
    assert ctx.gather_rows(x) is x and ctx.combine(x) is x
    assert ctx.all_reduce(x) is x and torch.equal(x, torch.arange(6.0)
                                                  .view(3, 2))


@pytest.mark.parametrize("rank", [0, 1])
def test_two_ranks_gather_and_merge_as_jax(two_ranks, rank, monkeypatch):
    r = two_ranks[rank]
    assert (r["count"], r["index"], r["main"]) == (2, rank, rank == 0)
    assert r["gathered"] == DICTS
    assert r["merged"] == _jax_merge(monkeypatch, DICTS, rank)
    # the union, later ranks overwriting earlier ones on a shared key
    assert r["merged"][1002] == "three" and len(r["merged"]) == 5


@pytest.mark.parametrize("rank", [0, 1])
def test_collectives_are_exact(two_ranks, rank):
    r = two_ranks[rank]
    want = np.concatenate(_rows()).view(np.int32)
    np.testing.assert_array_equal(r["bits"], want)
    np.testing.assert_array_equal(r["replicated"], np.zeros(3, np.float32))
    rank0 = torch.rand(4, generator=torch.Generator().manual_seed(100))
    np.testing.assert_array_equal(r["gen"], rank0.numpy())
    assert r["stats"]["all_reduce_calls"] >= 1 and \
        r["stats"]["broadcast_calls"] == 2


def test_make_mesh_on_two_ranks_follows_jax_arithmetic(two_ranks):
    from vqacl_tpu.parallel.mesh import make_mesh as jax_make_mesh
    import jax

    errs = two_ranks[0]["mesh_errors"]
    assert two_ranks[0]["auto_dp"] == 2
    assert errs["{'dp': 1}"] == "dp*tp*pp=1 != n_devices=2"
    assert errs["{'dp': 3}"] == "dp*tp*pp=3 != n_devices=2"
    with pytest.raises(AssertionError, match=r"dp\*tp\*pp=3 != n_devices=2"):
        jax_make_mesh(dp=3, devices=jax.devices()[:2])
    # tp and pp take the two ranks as JAX's (dp, tp, pp) reshape does;
    # a tp the world does not divide still raises with JAX's message
    for k, r in (("{'tp': 2}", 0), ("{'pp': 2}", 0), ("{'tp': 2}", 1),
                 ("{'pp': 2}", 1)):
        shape = (1, 2, 1) if "tp" in k else (1, 1, 2)
        idx = (0, r, 0) if "tp" in k else (0, 0, r)
        assert two_ranks[r]["mesh_errors"][k] == shape + idx
    assert errs["{'tp': 3}"] == "2 devices not divisible by tp*pp=3"
