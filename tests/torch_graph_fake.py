"""A CPU stand-in for ``train/graph.py::CudaGraphs``.

A CUDA graph's capture runs nothing, and its replay runs the captured
work without any host-side counting. ``FakeGraphs`` models both on CPU
tensors: ``capture`` runs the body once and then puts back every slot
tensor and the generator's state (so the capture leaves no trace but
the host counters, which ``GraphedStep`` itself puts back), and a replay
runs the body again with the wrapper counters and the recorder's counts
it makes discarded, writing the body's output into the tensor that
``capture`` returned. Install it with ``install(monkeypatch)`` or
``install()``; ``capturable`` is made to accept CPU states too.
"""

import torch

from vqacl_tpu_torch.ops import launches
from vqacl_tpu_torch.train import graph as G
from vqacl_tpu_torch.utils import profiling as P


class FakeGraphs:
    def __init__(self, step):
        self.step = step
        self.replays = 0

    def run(self, fn):
        return fn()

    def capture(self, fn, generator):
        leaves = [t for s in self.step.slots for t in G.state_leaves(s.state)]
        saved = [t.clone() for t in leaves]
        rng = generator.get_state()
        out = fn().clone()
        for t, v in zip(leaves, saved):
            t.copy_(v)
        generator.set_state(rng)

        def replay():
            before = launches.read()
            with P.diverted():
                v = fn()
            launches.add(launches.since(before), -1)
            out.copy_(v)
            self.replays += 1

        return replay, out


def install(monkeypatch=None):
    """``GraphedStep`` on CPU states through ``FakeGraphs``."""
    pairs = ((G, "capturable", lambda state: True),
             (G.GraphedStep, "_backend", lambda self, dev: FakeGraphs(self)))
    for obj, name, value in pairs:
        if monkeypatch is None:
            setattr(obj, name, value)
        else:
            monkeypatch.setattr(obj, name, value)
