"""The port's training entry points (``cli/args.py``,
``cli/vqacl_train.py``, ``cli/nextqa_train.py``) against the JAX
package's.

``parse_config`` gives the JAX package's config field for field (and the
same parsed flags) on the verbatim argv of ``scripts/VQACL_train.sh``,
``VQACL_COMP_train.sh`` and ``nextqa_train.sh``, on the TPU-flag argv of
``tests/test_cli.py`` and on ``--tiny_model``; only ``fused_attention``
differs, JAX's ``auto`` being the port's True. ``--platform auto`` (and
``cuda``) raise without a card instead of running on the CPU. Each CLI's
``main`` hands its trainer the same config, data-module arguments and
trainer class, and calls the same method, as JAX's ``main`` on the same
argv (both trainers captured). ``vqacl_train.main --platform cpu
--tiny_model`` over a reference-format root (two tasks) leaves the files
JAX's CLI leaves; its eval-only run gives the training run's metrics and
``--checkpoint <task>`` resumes after that task. The backbone start
takes ``--backbone``'s ``model.safetensors``. A SIGTERM leaves
``{task}_EMERGENCY`` and a non-zero exit. The config's yaml round trip
holds.
"""

import dataclasses
import json
import os
import shlex
import shutil
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import vqacl_tpu.cl.comp_trainer as JCompMod  # noqa: E402
import vqacl_tpu.cli.nextqa_train as JNext  # noqa: E402
import vqacl_tpu.cli.vqacl_train as JVqa  # noqa: E402
import vqacl_tpu_torch.cli.nextqa_train as TNext  # noqa: E402
import vqacl_tpu_torch.cli.vqacl_train as TVqa  # noqa: E402
from vqacl_tpu.cli.args import build_parser as j_parser  # noqa: E402
from vqacl_tpu.cli.args import parse_config as j_parse  # noqa: E402
from vqacl_tpu.data.features import write_h5  # noqa: E402
from vqacl_tpu_torch.cli.args import build_parser as t_parser  # noqa: E402
from vqacl_tpu_torch.cli.args import parse_config as t_parse  # noqa: E402
from vqacl_tpu_torch.cli.args import platform_device  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TASKS = ["q_recognition", "q_location"]
# what JAX's CLI leaves for these two tasks (tests/test_real_artifacts.py)
CLI_FILES = sorted([f"{t}_LAST.npz" for t in TASKS] + [
    "Q_prototype.npy", "V_prototype.npy", "metrics.json", "train_log.jsonl"])


def script_argv(name):
    """The flags of ``scripts/<name>`` as its shell passes them."""
    with open(os.path.join(REPO, "scripts", name)) as f:
        text = f.read()
    output = next(l.split("=", 1)[1].replace("$name", l2.split("=", 1)[1])
                  for l in text.splitlines() if l.startswith("output=")
                  for l2 in text.splitlines() if l2.startswith("name="))
    body = text.split("python -m ", 1)[1].split('"$@"', 1)[0]
    argv = shlex.split(body.replace("\\\n", " "))[1:]
    return [output if a == "$output" else a for a in argv]


ARGVS = {
    "VQACL_train.sh": script_argv("VQACL_train.sh"),
    "VQACL_COMP_train.sh": script_argv("VQACL_COMP_train.sh"),
    "nextqa_train.sh": script_argv("nextqa_train.sh"),
    "tpu_flags": ["--mesh_dp", "4", "--mesh_tp", "2", "--dtype", "float32",
                  "--remat", "--device_cache", "--use_memory_loss"],
    "tiny_model": ["--tiny_model"],
    "options": ["--grad_accum", "2", "--fused_attention", "off",
                "--adam_dtype", "float32", "--param_layout", "fsdp",
                "--train_topk", "7", "--valid_topk", "3", "--cl_reg",
                "derpp", "--checkpoint", "q_location", "--backbone",
                "/weights/t5", "--tokenizer", "spiece.model",
                "--device_cache_dtype", "int8", "--fused_decoder",
                "--folded_cross_kv", "--pp_micro", "2", "--num_workers",
                "2"],
    "alias": ["--gradient_accumulation_steps", "3", "--fused_attention",
              "on"],
}


def _assert_config_equal(t, j, fused):
    for part in ("model", "train", "mesh", "data"):
        tp, jp = getattr(t, part), getattr(j, part)
        for f in dataclasses.fields(tp):
            want = getattr(jp, f.name)
            if (part, f.name) == ("model", "fused_attention"):
                want = fused
            assert getattr(tp, f.name) == want, (part, f.name)
    for name in ("output", "backbone", "verbose"):
        assert getattr(t, name) == getattr(j, name), name


@pytest.mark.parametrize("case", list(ARGVS))
def test_parse_config_matches_jax(case):
    argv = ARGVS[case]
    t, j = t_parse(argv), j_parse(argv)
    assert vars(t._cli) == vars(j._cli)
    fused = {"auto": True, "on": True, "off": False}[t._cli.fused_attention]
    _assert_config_equal(t, j, fused)
    if case == "alias":
        assert t.train.grad_accum == 3
    if case == "tiny_model":
        assert (t.model.d_model, t.model.feat_dim, t.model.n_boxes,
                t.model.max_text_length, t.model.target_max_length) == \
            (32, 2048, 36, 20, 10)


def test_parser_flags_match_jax():
    def flags(p):
        return {a.dest: (tuple(a.option_strings), a.default, a.type,
                         a.nargs, a.const)
                for a in p._actions if a.dest != "help"}

    t, j = flags(t_parser()), flags(j_parser())
    assert t == j
    tplat = next(a for a in t_parser()._actions if a.dest == "platform")
    assert tplat.choices == ["auto", "cuda", "cpu"]
    assert ARGVS["VQACL_train.sh"][:2] == ["--train", "karpathy_train"]
    assert "--seed" in ARGVS["nextqa_train.sh"]


@pytest.mark.parametrize("platform", ["auto", "cuda"])
def test_platform_auto_raises_without_cuda(platform, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the card is found")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        platform_device(platform)
    for mod in (TVqa, TNext):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mod.main(["--platform", platform, "--dataset_root",
                      str(tmp_path / "missing"), "--output",
                      str(tmp_path / "out"), "--now_train"])
    assert platform_device("cpu") == torch.device("cpu")


@pytest.fixture
def keep_sigterm():
    handler = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, handler)


class _Capture:
    """Stands in for a trainer class: records what ``main`` hands it and
    which method ``main`` calls."""

    def __init__(self, log, kind):
        self.log, self.kind = log, kind

    def __call__(self, cfg, data, tok, **kw):
        self.log.update(kind=self.kind, cfg=cfg, data=data, tok=tok, kw=kw)
        return self

    def train(self, resume_task=None):
        self.log["call"] = ("train", resume_task)
        return {}

    def Test(self):
        self.log["call"] = ("Test",)
        return {}


class _Data:
    """Stands in for a data module: records its arguments."""

    def __init__(self, *a, **kw):
        self.args = (a[0],) + a[2:], kw

    @classmethod
    def from_root(cls, root, tok, **kw):
        return cls(root, tok, **kw)


def _capture(monkeypatch, pkg):
    log = {}
    if pkg == "jax":
        mods = (JVqa, JNext)
        for m in mods:
            monkeypatch.setattr(m, "install_cli_runtime", lambda cli: None)
        monkeypatch.setattr(JCompMod, "CompVQACLTrainer",
                            _Capture(log, "CompVQACLTrainer"))
    else:
        mods = (TVqa, TNext)
    for m in mods:
        monkeypatch.setattr(m, "VQACLTrainer", _Capture(log, "VQACLTrainer"))
        if hasattr(m, "CompVQACLTrainer"):   # JAX's nextqa imports it late
            monkeypatch.setattr(m, "CompVQACLTrainer",
                                _Capture(log, "CompVQACLTrainer"))
    monkeypatch.setattr(mods[0], "VQADataModule", _Data)
    monkeypatch.setattr(mods[1], "NextQADataModule", _Data)
    return log


@pytest.mark.parametrize("cli,argv", [
    ("vqacl_train", ARGVS["VQACL_train.sh"]),
    ("vqacl_train", ARGVS["VQACL_COMP_train.sh"]),
    ("vqacl_train", ["--from_scratch", "--dtype", "float32", "--checkpoint",
                     "q_judge", "--now_train", "--train_topk", "9"]),
    ("vqacl_train", ["--tiny_model", "--comp_cate", "G2"]),
    ("nextqa_train", ARGVS["nextqa_train.sh"]),
    ("nextqa_train", ARGVS["nextqa_train.sh"] + ["--comp_cate", "G2"]),
    ("nextqa_train", ["--from_scratch", "--comp_cate", "G5"]),
])
def test_main_hands_the_trainer_what_jax_main_does(cli, argv, monkeypatch,
                                                   keep_sigterm):
    logs = {}
    for pkg, mod in (("jax", {"vqacl_train": JVqa,
                              "nextqa_train": JNext}[cli]),
                     ("port", {"vqacl_train": TVqa,
                               "nextqa_train": TNext}[cli])):
        log = _capture(monkeypatch, pkg)
        mod.main(argv + ["--platform", "cpu"])
        logs[pkg] = log
    j, t = logs["jax"], logs["port"]
    assert t["kind"] == j["kind"]
    assert t["call"] == j["call"]
    assert t["data"].args == j["data"].args
    assert type(t["tok"]).__name__ == type(j["tok"]).__name__
    fused = True if t["cfg"]._cli.fused_attention != "off" else False
    _assert_config_equal(t["cfg"], j["cfg"], fused)
    assert str(t["kw"]["dtype"]) == f"torch.{jnp.dtype(j['kw']['dtype'])}"
    assert t["kw"]["device"] == torch.device("cpu")
    assert t["kw"].get("init_params") is None
    assert j["kw"].get("init_params") is None
    if cli == "nextqa_train":
        assert (t["cfg"].model.max_text_length, t["cfg"].model.n_boxes,
                t["cfg"].model.target_max_length,
                t["cfg"].model.n_ques_types, t["cfg"].train.schedule,
                t["cfg"].train.lambda_Q, t["cfg"].train.lambda_V) == \
            (23, 16, 6, 8, "linear_warmup", 0.0, 0.0)


def write_root(root, n=(16, 4, 4), seed=0):
    """Reference-format VQA v2 root of ``TASKS`` (h5 features), as
    tests/test_real_artifacts.py writes it."""
    rng = np.random.default_rng(seed)
    os.makedirs(root / "vqa" / "Partition_Q")
    os.makedirs(root / "COCO" / "features")
    ques_map, cate_map, recs, qid = {}, {}, [], 0
    for t_idx, task in enumerate(TASKS):
        for split, k in zip(("karpathy_train", "karpathy_val",
                             "karpathy_test"), n):
            items = []
            for _ in range(k):
                img_id = f"COCO_val2014_{qid:012d}"
                c = int(rng.integers(0, 80))
                cate_map[img_id] = c
                ques_map[str(qid)] = t_idx
                ans = f"ans{c % 3}"
                items.append({"img_id": img_id, "question_id": qid,
                              "sent": f"what is category {c}",
                              "label": {ans: 1.0},
                              "answers": [{"answer": ans}] * 10,
                              "question_type": "what is",
                              "answer_type": "other"})
                boxes = rng.uniform(0, 50, (36, 4)).astype(np.float32)
                boxes[:, 2:] += boxes[:, :2]
                recs.append((img_id, {
                    "features": (np.full((36, 2048), c / 80.0, np.float32)
                                 + 0.1 * rng.normal(size=(36, 2048))
                                 ).astype(np.float32),
                    "boxes": boxes.clip(0, 100), "img_h": 100,
                    "img_w": 100}))
                qid += 1
            with open(root / "vqa" / "Partition_Q" / f"{split}_{task}.json",
                      "w") as f:
                json.dump(items, f)
    with open(root / "QuesId_task_map.json", "w") as f:
        json.dump(ques_map, f)
    with open(root / "ImgId_cate_map.json", "w") as f:
        json.dump(cate_map, f)
    write_h5(str(root / "COCO" / "features" / "val2014_obj36.h5"), recs)
    return str(root)


@pytest.fixture
def two_tasks(monkeypatch):
    """The CLI builds all ten tasks; restrict it to the two written."""
    import vqacl_tpu_torch.data.vqa_module as vm

    orig = vm.VQADataModule.__init__

    def patched(self, root, tok, tasks=None, **kw):
        orig(self, root, tok, tasks=TASKS, **kw)

    monkeypatch.setattr(vm.VQADataModule, "__init__", patched)


def test_cli_end_to_end_on_the_cpu(tmp_path, two_tasks, keep_sigterm):
    pytest.importorskip("h5py")
    root = write_root(tmp_path / "root")
    out = str(tmp_path / "snap")
    args = ["--platform", "cpu", "--dataset_root", root, "--output", out,
            "--tiny_model", "--batch_size", "8", "--valid_batch_size", "8",
            "--epochs", "1", "--m_size", "10", "--memory", "--from_scratch",
            "--lr", "1e-2", "--dtype", "float32"]
    metrics = TVqa.main(args + ["--now_train"])
    assert sorted(os.listdir(out)) == CLI_FILES
    with open(os.path.join(out, "metrics.json")) as f:
        saved = json.load(f)
    assert saved["Avg_acc"] == metrics["Avg_acc"]
    with open(os.path.join(out, "train_log.jsonl")) as f:
        lines = [json.loads(l) for l in f]
    tasks = [e["task"] for e in lines[:-1]]
    assert tasks == sorted(tasks, key=TASKS.index) and set(tasks) == set(TASKS)
    # eval-only: Test() over the saved checkpoints gives the same metrics
    assert TVqa.main(args) == metrics
    # --checkpoint <task>: resume after the first task
    resumed = str(tmp_path / "resumed")
    os.makedirs(resumed)
    shutil.copy(os.path.join(out, f"{TASKS[0]}_LAST.npz"), resumed)
    args_r = [resumed if a == out else a for a in args]
    TVqa.main(args_r + ["--now_train", "--checkpoint", TASKS[0]])
    with open(os.path.join(resumed, "train_log.jsonl")) as f:
        lines = [json.loads(l) for l in f]
    assert [e["task"] for e in lines[:-1]] == \
        [t for t in tasks if t == TASKS[1]]
    assert os.path.exists(os.path.join(resumed, f"{TASKS[1]}_LAST.npz"))


def test_backbone_start_reads_the_safetensors(tmp_path, keep_sigterm):
    """Without --from_scratch (and not --tiny_model) the trainer starts
    from ``--backbone``; a directory without weights falls back to the
    seeded random start; a file without the visual embedding (vanilla
    t5-base) gets the seeded init's. A tiny config stands in for
    t5-base."""
    from vqacl_tpu_torch.data.synthetic_module import SyntheticDataModule
    from vqacl_tpu_torch.data.tokenizer import VLT5Tokenizer
    from vqacl_tpu_torch.models import hf_import, vlt5
    from vqacl_tpu_torch.train.checkpoint import _flat_tensors
    from vqacl_tpu_torch.utils.config import tiny_model_config

    m = tiny_model_config(vocab_size=32200)
    params = vlt5.init_vlt5_params(7, m, device="cpu")
    sd = hf_import.to_state_dict(params, m)
    os.makedirs(tmp_path / "w")
    hf_import.write_safetensors(sd, str(tmp_path / "w" / "model.safetensors"))
    # a vanilla t5-base file: no visual embedding
    os.makedirs(tmp_path / "t5")
    hf_import.write_safetensors(
        {k: v for k, v in sd.items() if "visual_embedding" not in k},
        str(tmp_path / "t5" / "model.safetensors"))
    data = SyntheticDataModule(VLT5Tokenizer(), tasks=TASKS,
                               n_train_per_task=8, n_val_per_task=4,
                               n_test_per_task=4, feat_dim=m.feat_dim,
                               n_boxes=m.n_boxes)
    starts = {}
    for backbone in (str(tmp_path / "w"), str(tmp_path / "empty"),
                     str(tmp_path / "t5")):
        cfg = t_parse(["--platform", "cpu", "--backbone", backbone,
                       "--output", str(tmp_path / "out"), "--dtype",
                       "float32"])
        cfg.model = tiny_model_config(vocab_size=32200)
        starts[backbone] = _flat_tensors(
            TVqa.make_trainer(cfg, data=data).state.params)
    got, ref = starts[str(tmp_path / "w")], _flat_tensors(params)
    assert got.keys() == ref.keys()
    assert all(torch.equal(got[k], ref[k]) for k in ref)
    scratch = starts[str(tmp_path / "empty")]
    assert not torch.equal(scratch["shared"], ref["shared"])
    # the t5 weights from the file, the visual embedding the seeded init's
    t5 = starts[str(tmp_path / "t5")]
    assert t5.keys() == ref.keys()
    for k in ref:
        want = scratch[k] if k.startswith("visual_embedding") else ref[k]
        assert torch.equal(t5[k], want), k


def test_sigterm_writes_emergency_checkpoint(tmp_path, vqa_root_full):
    """SIGTERM while training (eviction, timeout(1)) exits non-zero after
    writing ``{task}_EMERGENCY`` (the CLI's handler raises SystemExit in
    the main thread; the trainer's BaseException path saves)."""
    out = tmp_path / "snap"
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "vqacl_tpu_torch.cli.vqacl_train",
         "--platform", "cpu", "--dataset_root", vqa_root_full,
         "--output", str(out), "--tiny_model", "--batch_size", "8",
         "--valid_batch_size", "8", "--epochs", "50", "--m_size", "20",
         "--lr", "1e-3", "--now_train"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO,
        env=env)
    # a watchdog of its own: a silent subprocess would block readline
    killer = threading.Timer(300, proc.kill)
    killer.daemon = True
    killer.start()
    try:
        started = False
        for line in proc.stdout:
            if "-- group" in line:
                started = True
                break
        assert started, "training never started"
        time.sleep(2)
        proc.send_signal(signal.SIGTERM)
        proc.stdout.read()
        rc = proc.wait(timeout=120)
    finally:
        killer.cancel()
        if proc.poll() is None:
            proc.kill()
    assert rc != 0
    assert list(out.glob("*_EMERGENCY.npz")), list(out.iterdir())


def test_config_yaml_round_trip(tmp_path):
    pytest.importorskip("yaml")
    from vqacl_tpu.utils.config import Config as JConfig
    from vqacl_tpu_torch.utils.config import Config

    cfg = t_parse(ARGVS["nextqa_train.sh"] + ["--lr", "3e-4", "--m_size",
                                              "123", "--remat"])
    path = str(tmp_path / "cfg.yaml")
    cfg.save(path)
    back = Config.load(path)
    assert back == cfg and back.to_dict() == cfg.to_dict()
    assert back.train.lr == 3e-4 and back.train.m_size == 123
    # the JAX package reads the port's file: the same fields
    j = JConfig.load(path)
    _assert_config_equal(back, j, True)
    assert Config.from_dict({"output": "x", "train": {"lr": 0.5}}).train.lr \
        == 0.5
