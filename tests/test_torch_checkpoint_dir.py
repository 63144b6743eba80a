"""The directory checkpoint pair (``save_checkpoint_dcp`` /
``load_checkpoint_dcp``, over ``torch.distributed.checkpoint``) against
the JAX package's orbax pair.

One tree (tiny parameters, prototype banks made with numpy, a step)
saved by each package in its own directory format and restored without a
template: the port's round trip is bit-equal, and its restored tree
equals JAX's orbax restore of the same tree bit for bit (the two formats
are not interchangeable, so the trees are compared, not the files). One
process, no process group, and no warning about it.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from torch_parity import jax_tiny_params  # noqa: E402
from vqacl_tpu.models.prototype import ProtoState as JProto  # noqa: E402
from vqacl_tpu_torch.models.convert import from_jax_params  # noqa: E402
from vqacl_tpu_torch.models.prototype import ProtoState  # noqa: E402
from vqacl_tpu_torch.train.checkpoint import (load_checkpoint_dcp,  # noqa: E402
                                              save_checkpoint_dcp)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree.numpy() if isinstance(tree, torch.Tensor)
            else np.asarray(tree)}


def _tree(seed=0):
    jcfg, params = jax_tiny_params(seed)
    rng = np.random.default_rng(seed + 1)
    proto = {f: rng.normal(size=s).astype(np.float32) for f, s in (
        ("q_proto", (10, jcfg.d_model)), ("v_proto", (80, jcfg.d_model)))}
    return params, proto


def _port_proto(proto_np):
    p = ProtoState.create(10, 80, proto_np["q_proto"].shape[1], device="cpu")
    return p._replace(q_proto=torch.from_numpy(proto_np["q_proto"]),
                      v_proto=torch.from_numpy(proto_np["v_proto"]))


def test_round_trip_is_bit_equal(tmp_path):
    params, proto_np = _tree()
    tp, proto = from_jax_params(params), _port_proto(proto_np)
    proto = proto._replace(q_num=proto.q_num + 3.0,
                           task_id=proto.task_id + 2)
    d = str(tmp_path / "ckpt")
    with warnings.catch_warnings():
        warnings.simplefilter("error")      # nothing about one process
        save_checkpoint_dcp(d, tp, proto, step=11)
        params2, proto2, step = load_checkpoint_dcp(d)
    assert step == 11
    a, b = _flat(params2), _flat(tp)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for name in ProtoState._fields:
        x, y = getattr(proto2, name), getattr(proto, name)
        assert x.dtype == y.dtype and torch.equal(x, y), name
    # a second save overwrites the directory
    save_checkpoint_dcp(d, tp, proto, step=12)
    assert load_checkpoint_dcp(d)[2] == 12


def test_restored_tree_equals_jax_orbax(tmp_path):
    pytest.importorskip("orbax.checkpoint")
    from vqacl_tpu.train.checkpoint import (load_checkpoint_orbax,
                                            save_checkpoint_orbax)

    params, proto_np = _tree(2)
    jproto = JProto.create(10, 80, proto_np["q_proto"].shape[1])
    jproto = jproto._replace(**{k: jax.numpy.asarray(v)
                                for k, v in proto_np.items()})
    save_checkpoint_orbax(str(tmp_path / "orbax"), params, jproto, step=4)
    jparams, jproto2, jstep = load_checkpoint_orbax(str(tmp_path / "orbax"))
    save_checkpoint_dcp(str(tmp_path / "dcp"), from_jax_params(params),
                        _port_proto(proto_np), step=4)
    tparams, tproto, tstep = load_checkpoint_dcp(str(tmp_path / "dcp"))
    assert tstep == jstep == 4
    a, b = _flat(tparams), _flat(jax.device_get(jparams))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for name in ProtoState._fields:
        np.testing.assert_array_equal(getattr(tproto, name).numpy(),
                                      np.asarray(getattr(jproto2, name)),
                                      err_msg=name)
