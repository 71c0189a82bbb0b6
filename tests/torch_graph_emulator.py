"""CUDA-graph capture and replay emulated on the CPU, for the tests of the
port's step graphs (``duodiff_tpu_torch/diffusion/graphs.py``).

A CUDA graph replays the kernels its capture recorded, on the same memory,
with every host value as it was at the capture. Here every aten op a step
body runs during capture is recorded (a TorchDispatchMode), and a replay
runs the recorded ops again on the same persistent tensors, with the
capture's scalars, below autograd and without bumping a version counter,
as a graph's replay does. The first replay after a capture does nothing,
since the recording ran the step. So a body that read a host value which
the host moves between steps, wrote a tensor it had rebound or made its
state anew drifts from the eager steps here as it would on the card; and a
body that reads a value on the host during capture (``.item()``, ``bool()``
of a tensor, ``torch.equal``) fails here as a capture fails on the card.

Use the ``emulated`` fixture (import it into the test module): it returns a
factory of emulated runs, ``make() -> StepGraphs``, graphed on the CPU; or
:func:`emulate` with a ``monkeypatch`` to patch the graphs module alone.
:class:`EmulatedStepGraphs` is a run class that is graphed when asked, for
code that builds its own runs from ``graphs.StepGraphs``.
"""

import contextlib

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map

from duodiff_tpu_torch.diffusion import graphs

# aten ops whose result is a host value read from a tensor
HOST_READS = ("aten::_local_scalar_dense", "aten::equal", "aten::is_nonzero", "aten::item")


class HostReadDuringCapture(RuntimeError):
    pass


class _Recorder(TorchDispatchMode):
    def __init__(self, ops: list):
        super().__init__()
        self.ops = ops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func._schema.name in HOST_READS:
            raise HostReadDuringCapture(f"{func} reads a value on the host inside a captured "
                                        "step body")
        out = func(*args, **kwargs)
        self.ops.append((func, args, kwargs, out))
        return out


class _EmulatedGraph:
    """The ops a capture recorded, run again at every replay but the first."""

    def __init__(self):
        self.ops, self.replays = [], 0

    def replay(self):
        self.replays += 1
        if self.replays == 1:
            return  # the capture's recording ran this step
        memo = {}

        def mapped(tree):
            return tree_map(lambda t: memo.get(id(t), t) if isinstance(t, torch.Tensor) else t,
                            tree)

        with torch.no_grad(), torch._C._AutoDispatchBelowADInplaceOrView():
            for func, args, kwargs, out in self.ops:
                new = func(*mapped(args), **mapped(kwargs))
                for o, n in zip(tree_leaves(out), tree_leaves(new)):
                    if isinstance(o, torch.Tensor) and o is not n:
                        memo[id(o)] = n


@contextlib.contextmanager
def _record(graph, pool):
    with _Recorder(graph.ops):
        yield


class _HostStepGraph(graphs.StepGraph):
    """A step graph whose static buffers may lie on the CPU."""

    def __init__(self, body, buffers=(), pool=None):
        super().__init__(body, (), pool)


class EmulatedStepGraphs(graphs.StepGraphs):
    """A run that is graphed whenever it is asked to be, on the CPU too."""

    def __init__(self, device, graphed: bool = True):
        super().__init__(device, graphed)
        self.graphed = bool(graphed)


def emulate(monkeypatch) -> None:
    """Capture and replay through the emulated graph."""
    monkeypatch.setattr(graphs, "_new_graph", _EmulatedGraph)
    monkeypatch.setattr(graphs, "_capture", _record)
    monkeypatch.setattr(graphs, "StepGraph", _HostStepGraph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)


@pytest.fixture
def emulated(monkeypatch):
    """Step graphs on the CPU that capture and replay as above."""
    emulate(monkeypatch)

    def make():
        return EmulatedStepGraphs("cpu")

    return make
