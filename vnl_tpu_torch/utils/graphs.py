"""CUDA graphs of the port's hot loops: the counterpart of the JAX
package's compiled programs (its control step and SGD update are jitted
scans, vnl_tpu/training/train.py:279-284).

``Graph`` captures a function of static CUDA tensors once and replays it:
one launch from the host for the thousands of kernels a control step or
an SGD update launches.  The tensors a replay reads are the ones it was
captured with, so a caller writes its inputs into them in place
(``copy_``) and reads the outputs the capture returned, which the next
replay overwrites.

What a capture needs, and the helper sees to:
  - a warm-up: ``warm_up`` runs the function once eagerly on a side
    stream, so that every first-use cache (the kernels' device tables,
    ``Model.cache``, cuBLAS' handles) is filled before the capture; the
    callers make that run their first real call, so it changes nothing;
  - a private memory pool for the capture's tensors;
  - the explicit ``torch.Generator``s the function draws from, registered
    with the graph, so that each replay advances them as the eager calls
    would and draws the same numbers;
  - the launch counters (``ops.launch_counts``, the collectives'
    ``parallel.mesh.collective_counts``): a capture runs the wrappers'
    Python, which counts, but launches nothing; the counts of the capture
    are taken back and added once for every replay.

The control step tags its parts (``profiler.part``: the physics'
``position``, ``collision``, ``constraints``, ``velocity``, ``solve`` and
``integrate`` stages, the ``policy`` and the rest of the ``env``), the
SGD update its GAE (``gae``, kernel F).  A capture reads the graph in
progress as each tagged part begins and ends and keeps the nodes each
added (the innermost part open gets them) in its report, ``parts``; a
replay adds them to the ``graph_nodes.<part>`` counters of an open
``profiler.recording``.

On the CPU nothing is captured: a ``Graph`` of CPU tensors raises, and
the callers run their eager code there.  A failed capture raises; nothing
falls back to eager.

The nest helpers (``leaves``, ``named_leaves``, ``map_leaves``,
``clone``, ``copy_``) walk dicts, lists,
tuples (named ones too) and dataclasses (``State``, ``Data``)."""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import json
import sys
import time
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import torch

from vnl_tpu_torch.ops import ReplayCounts, launch_counts
from vnl_tpu_torch.parallel.mesh import collective_counts
from vnl_tpu_torch.utils import profiler

# every capture's report, in order: name, capture and instantiate
# seconds, the graph's node count, the nodes of each tagged part, its
# pool's bytes and the launches a replay counts
REPORTS: List[dict] = []


def leaves(x) -> List[torch.Tensor]:
    """The tensors of a nest, in a fixed order."""
    return [t for _, t in named_leaves(x)]


def named_leaves(x, path: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, tensor) of every tensor of a nest, dicts in key order."""
    if torch.is_tensor(x):
        yield path, x
    elif isinstance(x, dict):
        for k in sorted(x):
            yield from named_leaves(x[k], f"{path}[{k!r}]")
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            yield from named_leaves(v, f"{path}[{i}]")
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            yield from named_leaves(getattr(x, f.name), f"{path}.{f.name}")


def map_leaves(fn: Callable, x):
    """The nest with ``fn`` applied to each of its tensors."""
    if torch.is_tensor(x):
        return fn(x)
    if isinstance(x, dict):
        return {k: map_leaves(fn, v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[map_leaves(fn, v) for v in x])
    if isinstance(x, (list, tuple)):
        return type(x)(map_leaves(fn, v) for v in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: map_leaves(fn, getattr(x, f.name))
            for f in dataclasses.fields(x)})
    return x


def clone(x):
    """A copy of the nest whose tensors are contiguous and each in storage
    of its own (two leaves of ``x`` that share a tensor get two copies)."""
    return map_leaves(
        lambda t: t.clone(memory_format=torch.contiguous_format), x)


def copy_(dst, src) -> None:
    """Writes every tensor of ``src`` into the tensor at the same place of
    ``dst`` (same structure, shapes and dtypes; dicts matched by key), with
    one ``torch._foreach_copy_``.  ``dst``'s tensors must not share
    storage with each other (``clone`` makes such a nest).  A tensor of
    ``src`` that is its own destination is left alone; one that shares
    storage with another destination is copied first, so that no write
    reaches a tensor before it is read."""
    d_paths, s_paths = list(named_leaves(dst)), list(named_leaves(src))
    if [p for p, _ in d_paths] != [p for p, _ in s_paths]:
        raise ValueError("copy_: the two nests differ in structure: "
                         f"{sorted({p for p, _ in d_paths} ^ {p for p, _ in s_paths})}")
    own = {d.untyped_storage().data_ptr() for _, d in d_paths
           if d.numel()}
    ds, ss = [], []
    for (path, d), (_, s) in zip(d_paths, s_paths):
        if d.shape != s.shape or d.dtype != s.dtype:
            raise ValueError(f"copy_: {path} is {s.dtype} {tuple(s.shape)}, "
                             f"its destination {d.dtype} {tuple(d.shape)}")
        if s is d or not d.numel():
            continue
        if s.untyped_storage().data_ptr() in own:
            s = s.clone()
        ds.append(d)
        ss.append(s)
    if ds:
        torch._foreach_copy_(ds, ss)


def enabled(cuda_graphs: Optional[bool], device, what: str) -> bool:
    """Whether ``what`` replays CUDA graphs: ``cuda_graphs`` None means on
    a CUDA device; True on another device raises."""
    on_cuda = torch.device(device).type == "cuda"
    if cuda_graphs is None:
        return on_cuda
    if cuda_graphs and not on_cuda:
        raise ValueError(f"{what}: cuda_graphs=True needs a CUDA device, got "
                         f"{str(device)!r}; the CPU runs eagerly")
    return bool(cuda_graphs)


def capture_s(state_graphs) -> float:
    """Seconds of the captures and instantiations of StateGraphs (those
    captured so far)."""
    return sum(g.report["capture_s"] + g.report["instantiate_s"]
               for g in state_graphs if g.report)


def require_cuda(x, what: str) -> None:
    """Raises unless every tensor of the nest lies on a CUDA device."""
    off = sorted({str(t.device) for t in leaves(x) if not t.is_cuda})
    if off:
        raise ValueError(f"{what}: CUDA graphs need CUDA tensors, got tensors "
                         f"on {off}; the CPU runs the eager code")


def warm_up(fn: Callable, *args, **kwargs):
    """``fn(*args, **kwargs)`` run eagerly on a side stream, which the
    current stream then waits for: the warm-up before a capture."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out = fn(*args, **kwargs)
    torch.cuda.current_stream().wait_stream(side)
    return out


@functools.lru_cache(maxsize=None)
def _libcuda() -> ctypes.CDLL:
    lib = ctypes.CDLL("libcuda.so.1")
    p = ctypes.c_void_p
    lib.cuGraphGetNodes.argtypes = [p, p, p]
    lib.cuGraphGetNodes.restype = ctypes.c_int
    lib.cuStreamGetCaptureInfo_v2.argtypes = [p, p, p, p, p, p]
    lib.cuStreamGetCaptureInfo_v2.restype = ctypes.c_int
    return lib


def _graph_nodes(graph: int) -> int:
    """The node count of a CUgraph (cuGraphGetNodes of libcuda)."""
    n = ctypes.c_size_t(0)
    err = _libcuda().cuGraphGetNodes(ctypes.c_void_p(graph), None,
                                     ctypes.byref(n))
    if err:
        raise RuntimeError(f"cuGraphGetNodes failed with CUresult {err}")
    return n.value


def _node_count(graph: torch.cuda.CUDAGraph) -> int:
    """The captured graph's node count."""
    return _graph_nodes(graph.raw_cuda_graph())


def _capturing_nodes() -> int:
    """The node count of the graph the current stream is capturing into
    (cuStreamGetCaptureInfo_v2 of libcuda)."""
    status, graph = ctypes.c_int(0), ctypes.c_void_p(None)
    err = _libcuda().cuStreamGetCaptureInfo_v2(
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
        ctypes.byref(status), None, ctypes.byref(graph), None, None)
    if err or not graph.value:
        raise RuntimeError(f"cuStreamGetCaptureInfo_v2 gave CUresult {err}, "
                           f"capture status {status.value}")
    return _graph_nodes(graph.value)


def _pool_bytes(graph: torch.cuda.CUDAGraph) -> int:
    """Bytes the caching allocator holds in the graph's private pool."""
    pool = tuple(graph.pool())
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == pool)


class Graph:
    """``fn(*args)`` captured once on the CUDA device of ``args``; each
    ``replay()`` runs it again on the tensors of ``args`` as they are then
    and returns the outputs of the capture, overwritten in place.

    Call ``warm_up`` with the same function first.  ``generators``: every
    ``torch.Generator`` ``fn`` draws from.  The capture prints one JSON
    line, {"cuda_graph": ...}, and appends it to ``REPORTS``; its
    ``parts`` holds the nodes of each part ``fn`` tags (``profiler.part``)."""

    def __init__(self, fn: Callable, args: Sequence, name: str,
                 generators: Sequence[torch.Generator] = ()):
        require_cuda(args, f"graph {name}")
        self.name = name
        self.args = tuple(args)      # the static inputs, kept alive
        self._graph = torch.cuda.CUDAGraph(keep_graph=True)
        for g in generators:
            self._graph.register_generator_state(g)
        self._counts = ReplayCounts(launch_counts, collective_counts)
        with profiler.span("graph.capture") as span:
            t0 = time.perf_counter()
            # thread_local: a render job's thread may use the device
            # meanwhile
            with self._counts.record(), torch.cuda.graph(
                    self._graph, capture_error_mode="thread_local"), \
                    profiler.parts_counted(_capturing_nodes) as parts:
                self.outputs = fn(*self.args)
            t1 = time.perf_counter()
            self._graph.instantiate()
            t2 = time.perf_counter()
        launches, collectives = self._counts.deltas
        self._nodes = _node_count(self._graph)
        self.report = dict(
            name=name, capture_s=t1 - t0, instantiate_s=t2 - t1,
            nodes=self._nodes, parts=dict(parts.counts),
            pool_bytes=_pool_bytes(self._graph),
            launches_per_replay=dict(launches),
            collectives_per_replay=dict(collectives))
        # the counters a replay adds to
        self._counters = [("graph_nodes", self._nodes)] + [
            (f"graph_nodes.{p}", n) for p, n in parts.counts.items()]
        if span is not None:
            span.attrs = dict(graph=name, nodes=self._nodes,
                              pool_bytes=self.report["pool_bytes"])
        REPORTS.append(self.report)
        print(json.dumps({"cuda_graph": self.report}), file=sys.stdout,
              flush=True)

    def replay(self):
        self._graph.replay()
        self._counts.replayed()
        for name, n in self._counters:
            profiler.count(name, n)
        return self.outputs
