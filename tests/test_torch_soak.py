"""The port's soak (``vqacl_tpu_torch/soak.py``) against ``scripts/soak.py``.

Both scripts run with their trainer and data module replaced by stubs
that keep what they were handed: the same config fields (t5-base, the
epochs, replay memory and device cache of each scale, bf16 compute) and
the same ``SyntheticDataModule`` arguments, small and ``--full``. A run
at tiny widths on the CPU reaches the ``SOAK`` line with the trainer's
records printed before it, and the default device is the card, which
raises without one (no CPU fallback).
"""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from vqacl_tpu_torch import soak as port  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_thread():
    """The tiny CL runs here are bound by the host's dispatch: one
    intra-op thread each (a thread per core, the default, oversubscribes
    a host that other test workers share and slows them many times)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Seen(Exception):
    """Raised by the stub trainer once it has kept its arguments."""


def _stubs(kept):
    def data(tok, **kw):
        kept["data"] = kw
        return object()

    def trainer(cfg, data, tok, **kw):
        kept["cfg"], kept["trainer_kw"] = cfg, kw
        raise Seen
    return data, trainer


def _jax_side(monkeypatch, argv):
    import vqacl_tpu.cl.trainer as JT
    import vqacl_tpu.data.synthetic_module as JS

    kept = {}
    data, trainer = _stubs(kept)
    monkeypatch.setattr(JS, "SyntheticDataModule", data)
    monkeypatch.setattr(JT, "VQACLTrainer", trainer)
    spec = importlib.util.spec_from_file_location(
        "jax_soak_script", os.path.join(REPO, "scripts", "soak.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr("sys.argv", ["soak.py", *argv])
    with pytest.raises(Seen):
        mod.main()
    return kept


def _port_side(monkeypatch, argv):
    kept = {}
    data, trainer = _stubs(kept)
    monkeypatch.setattr(port, "SyntheticDataModule", data)
    monkeypatch.setattr(port, "VQACLTrainer", trainer)
    with pytest.raises(Seen):
        port.main([*argv, "--device", "cpu"])
    return kept


def _fields(cfg):
    return {part: dataclasses.asdict(getattr(cfg, part))
            for part in ("model", "train", "data")}


@pytest.mark.parametrize("argv", [[], ["--full"]])
def test_soak_builds_jax_config_and_data(argv, monkeypatch, tmp_path):
    out = str(tmp_path / "snap")
    j = _jax_side(monkeypatch, [*argv, "--out", out])
    t = _port_side(monkeypatch, [*argv, "--out", out])
    assert t["data"] == j["data"]
    assert t["data"]["n_train_per_task"] == (29000 if argv else 1000)
    assert t["data"]["n_images"] == (12_400 if argv else None)
    assert "tasks" not in t["data"]           # all ten tasks
    jf, tf = _fields(j["cfg"]), _fields(t["cfg"])
    # fused_attention is "auto" in JAX's config and a boolean in the
    # port's (the kernels wherever the tensors lie on the card)
    assert jf["model"].pop("fused_attention") == "auto"
    assert tf["model"].pop("fused_attention") is True
    for part in ("model", "train", "data"):
        common = set(jf[part]) & set(tf[part])
        # the port's config has every field the JAX one sets here
        assert {"epochs", "m_size", "batch_size", "lr", "memory",
                "device_cache", "d_model", "num_layers", "fused_decoder",
                "vocab_size"} & set(jf[part]) <= common
        assert {k: tf[part][k] for k in common} == \
            {k: jf[part][k] for k in common}, part
    assert t["cfg"].output == j["cfg"].output == out
    assert (t["cfg"].train.epochs, t["cfg"].train.m_size) == \
        ((3, 5000) if argv else (1, 1000))
    assert t["cfg"].data.device_cache is True
    assert t["cfg"].model.d_model == 768          # t5-base
    assert j["trainer_kw"]["dtype"] == jnp.bfloat16
    assert t["trainer_kw"]["dtype"] == torch.bfloat16
    assert t["trainer_kw"]["verbose"] is j["trainer_kw"]["verbose"] is True
    assert t["trainer_kw"]["device"].type == "cpu"


def test_soak_tasks_cut_takes_the_first_tasks(monkeypatch):
    from vqacl_tpu_torch.cl.tasks import ALL_TASKS

    t = _port_side(monkeypatch, ["--full", "--tasks", "3"])
    assert t["data"]["tasks"] == ALL_TASKS[:3]


def test_soak_tiny_cpu_run_reaches_soak_line(monkeypatch, tmp_path, capsys):
    from vqacl_tpu_torch.utils.config import Config, tiny_model_config

    def tiny():
        c = Config()
        c.model = tiny_model_config(vocab_size=32200)
        c.train.batch_size = c.train.valid_batch_size = 8
        return c

    monkeypatch.setattr(port, "Config", tiny)
    monkeypatch.setitem(port.SCALES, "small", dict(
        epochs=1, m_size=8, n_train=8, n_images=None))
    monkeypatch.setattr(port, "N_VAL", 4)
    monkeypatch.setattr(port, "N_TEST", 4)
    rec = port.main(["--device", "cpu", "--out", str(tmp_path / "snap")])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1].startswith("SOAK small: ")
    assert "Avg_acc=" in lines[-1] and "Avg_forget=" in lines[-1]
    before = "\n".join(lines[:-1])
    for part in ("soak: wall per task q_recognition ", "soak: wall shares ",
                 "train + ", " replay steps, median ", "predict batches",
                 "soak: launches K1=0 K1'=0 K2=0 (the counts imply ",
                 "soak: peak device memory not measured (no card)"):
        assert part in before, part
    assert len(rec["task_wall_s"]) == 10
    m = np.asarray(rec["result_matrix"])
    assert m.shape == (10, 10)
    assert (m[np.tril_indices(10)] >= 0).all()
    assert (m[np.triu_indices(10, 1)] == -1).all()
    c = rec["counts"]
    assert c["train_steps"] > 0 and c["replay_steps"] > 0
    assert rec["expected_launches"] == port.expected_launches(c, 2)
    assert 0 < rec["call_span_share"] <= 1
    assert os.path.exists(tmp_path / "snap" / "q_causal_LAST.npz")


def test_soak_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(port, "SyntheticDataModule",
                        lambda *a, **k: pytest.fail("built data"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.main([])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.run()


def test_busy_window_profiles_the_steps_after_the_skip(monkeypatch):
    """``busy_window`` wraps the trainer's train steps: the window opens
    at step skip + 1 and closes after step skip + n (a synchronize at each
    end), every step's result passes through, and the record holds the
    window's host seconds, its kernels' device seconds (none on the CPU),
    their ratio and the seconds spent reading the trace."""
    syncs = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: syncs.append(len(calls)))
    calls = []

    class Trainer:
        def _train_step(self, use_memory_loss):
            def step(state, batch):
                calls.append(use_memory_loss)
                return state + 1, {"loss": batch}
            return step

    t = Trainer()
    win = port.busy_window(t, 3, skip=2)
    state = 0
    for i in range(8):
        state, m = t._train_step(i % 2 == 0)(state, float(i))
        assert m == {"loss": float(i)}
        assert ("busy_share" in win) == (i >= 4)
    assert state == 8 and len(calls) == 8
    assert syncs == [2, 5]          # before step 3, after step 5
    assert win["steps"] == 3 and win["wall_s"] > 0 and win["read_s"] >= 0
    # no kernel in a CPU trace: no busy share, rather than a zero one
    assert win["device_s"] == 0.0 and win["busy_share"] is None
