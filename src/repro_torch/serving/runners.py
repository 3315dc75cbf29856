"""CUDA graphs: the port's counterpart of the JAX package's compiled runners.

The JAX scheduler compiles each segment once per runner key
(``src/repro/serving/scheduler.py``, ``_shared_runner`` /
``_branch_runner``: ``jax.jit`` keyed by (phase, n_steps, samplers)), and
its launcher jits the decode step (``src/repro/launch/serve.py``).  Here
a segment or a decode step on CUDA tensors is captured once into a
``torch.cuda.CUDAGraph`` and replayed:

* one graph per key: the runner's key plus what ``jax.jit`` retraces on
  implicitly, every input tensor's shape, dtype and device (the grid's
  rank and shape among them) and every other input's value (an int
  ``fork_idx`` is baked into the graph);
* static input buffers, filled with ``copy_`` before each replay;
* a warm-up on a side stream before the capture, which also loads the
  kernel library and runs each launcher's first-call set-up
  (``cudaFuncSetAttribute``, the occupancy and SM-count queries) outside
  the capture;
* launch counts: a kernel wrapper counts each launch it makes, the warm-up
  and the one into the capture among them, and nothing runs a wrapper in a
  replay; so a graph's launches are read back from the graph itself, its
  kernel nodes by symbol through libcuda, checked at capture
  against what the wrappers launched into it, and each replay adds them to
  :data:`REPLAYED`;
* the model's cast-once weights refreshed before each segment's replay
  and when a decode starts (a copy gone stale is rewritten where the
  graph reads it);
* outputs copied out of the graph's memory pool on return: the next
  replay of the same graph overwrites them.

Only CUDA tensors come here: a caller on the CPU stays eager (the port's
device rule).  Nothing falls back: a capture or a replay that fails raises.
"""
from __future__ import annotations

import ctypes
import time
from typing import Any, Callable, Dict, Iterable, List, NamedTuple, Tuple

import torch

from repro_torch.kernels.ddim_step.ops import fused_cfg_ddim_step
from repro_torch.kernels.dpmpp_step.ops import fused_cfg_dpmpp_step
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.group_mean.ops import masked_group_mean
from repro_torch.kernels.ssd_scan.ops import ssd_chunked_kernel
from repro_torch.models import transformer as tfm
from repro_torch.serving.kvcache import _leaves, _map

#: every kernel wrapper, by the name its ``launches`` count goes under
WRAPPERS = {"flash_attention": flash_attention,
            "ddim_step": fused_cfg_ddim_step,
            "dpmpp_step": fused_cfg_dpmpp_step,
            "group_mean": masked_group_mean,
            "ssd_scan": ssd_chunked_kernel}

#: the ``__global__`` function behind each count (flash's per route), as it
#: appears in a kernel's symbol
KERNEL_SYMBOLS = {"flash_attention/sm90": "flash_sm90_kernel",
                  "flash_attention/tf32x3": "flash_tf32x3_kernel",
                  "ddim_step": "ddim_step_kernel",
                  "dpmpp_step": "dpmpp_step_kernel",
                  "group_mean": "group_mean_kernel",
                  "ssd_scan": "ssd_tc_kernel"}


def launch_counts() -> Dict[str, int]:
    """Every wrapper's launch count; flash's per route under
    ``flash_attention/<route>``."""
    counts = {name: fn.launches for name, fn in WRAPPERS.items()}
    for route, n in flash_attention.launches_by_route.items():
        counts[f"flash_attention/{route}"] = n
    return counts


def counts_delta(before: Dict[str, int], after: Dict[str, int]
                 ) -> Dict[str, int]:
    return {k: after[k] - before[k] for k in after}


def launches_of(symbols: Iterable[str]) -> Dict[str, int]:
    """The launches among kernel ``symbols`` (one a launch), keyed as
    :func:`launch_counts`; any other kernel is not counted."""
    counts = dict.fromkeys(launch_counts(), 0)
    for sym in symbols:
        for key, name in KERNEL_SYMBOLS.items():
            if name in sym:
                counts[key] += 1
                if key.startswith("flash_attention/"):
                    counts["flash_attention"] += 1
    return counts


#: launches made by graph replays, keyed as :func:`launch_counts`: each
#: replay adds its graph's kernel nodes (no wrapper runs in a replay)
REPLAYED: Dict[str, int] = dict.fromkeys(launch_counts(), 0)


def _replayed(launches: Dict[str, int]) -> None:
    for key, n in launches.items():
        REPLAYED[key] += n


def signature(tree) -> Tuple:
    """What ``jax.jit`` retraces on: each tensor's shape, dtype and device,
    and every other leaf's type and value."""
    return tuple((tuple(x.shape), x.dtype, x.device)
                 if isinstance(x, torch.Tensor) else (type(x).__name__, x)
                 for x in _leaves(tree))


# -- a captured graph's kernel nodes, through libcuda ----------------------
_KERNEL_NODE = 0                              # CUgraphNodeType


class _KernelNodeParams(ctypes.Structure):
    """``CUDA_KERNEL_NODE_PARAMS_v2``."""
    _fields_ = [("func", ctypes.c_void_p),
                ("grid", ctypes.c_uint * 3), ("block", ctypes.c_uint * 3),
                ("shared_mem_bytes", ctypes.c_uint),
                ("kernel_params", ctypes.c_void_p),
                ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def _libcuda():
    cu = getattr(_libcuda, "lib", None)
    if cu is None:
        cu = _libcuda.lib = ctypes.CDLL("libcuda.so.1")
        ptr, ptrs = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)
        size = ctypes.POINTER(ctypes.c_size_t)
        for name, args in (
                ("cuGraphGetNodes", [ptr, ptrs, size]),
                ("cuGraphNodeGetType", [ptr, ctypes.POINTER(ctypes.c_int)]),
                ("cuGraphKernelNodeGetParams_v2",
                 [ptr, ctypes.POINTER(_KernelNodeParams)]),
                ("cuFuncGetName", [ctypes.POINTER(ctypes.c_char_p), ptr]),
                ("cuKernelGetName", [ctypes.POINTER(ctypes.c_char_p), ptr])):
            getattr(cu, name).argtypes = args
            getattr(cu, name).restype = ctypes.c_int
    return cu


def _cu(result: int, call: str) -> None:
    if result != 0:
        raise RuntimeError(f"{call} failed with CUresult {result}")


class KernelNode(NamedTuple):
    """One kernel node of a captured graph: its symbol and launch shape."""
    symbol: str
    grid: Tuple[int, int, int]
    block: Tuple[int, int, int]


def kernel_nodes(graph: torch.cuda.CUDAGraph) -> List[KernelNode]:
    """Every kernel node of a captured graph (one a launch of a replay),
    read back through libcuda.  A capture makes no child-graph nodes; a
    kernel of the port's inside one would be missing here, and
    :func:`capture`'s check would raise."""
    cu = _libcuda()
    graph = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    _cu(cu.cuGraphGetNodes(graph, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    _cu(cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    out, names = [], {}               # a function's symbol, looked up once
    for node in nodes:
        kind = ctypes.c_int()
        _cu(cu.cuGraphNodeGetType(node, ctypes.byref(kind)),
            "cuGraphNodeGetType")
        if kind.value != _KERNEL_NODE:
            continue
        p = _KernelNodeParams()
        _cu(cu.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(p)),
            "cuGraphKernelNodeGetParams")
        fn = p.func or p.kern
        if fn not in names:
            name = ctypes.c_char_p()
            if p.func:
                _cu(cu.cuFuncGetName(ctypes.byref(name), p.func),
                    "cuFuncGetName")
            else:
                _cu(cu.cuKernelGetName(ctypes.byref(name), p.kern),
                    "cuKernelGetName")
            names[fn] = name.value.decode()
        out.append(KernelNode(names[fn], tuple(p.grid), tuple(p.block)))
    return out


def kernel_symbols(graph: torch.cuda.CUDAGraph) -> List[str]:
    """The symbol of every kernel node of a captured graph."""
    return [node.symbol for node in kernel_nodes(graph)]


def _warm_up(fn: Callable, args: Tuple) -> None:
    """``fn(*args)`` once on a side stream, as ``torch.cuda.graphs``
    asks before a capture."""
    dev = next(x for x in _leaves(args) if isinstance(x, torch.Tensor)
               ).device
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        fn(*args)
    torch.cuda.current_stream(dev).wait_stream(side)


def _record(fn: Callable, args: Tuple) -> Tuple[torch.cuda.CUDAGraph, Any]:
    """``fn(*args)`` captured; the graph kept for :func:`kernel_symbols`
    and instantiated."""
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        out = fn(*args)
    graph.instantiate()
    return graph, out


def capture(fn: Callable, *args) -> Tuple[torch.cuda.CUDAGraph, Any,
                                           Dict[str, int]]:
    """``fn(*args)`` warmed up, then captured into a new graph.  Returns
    ``(graph, outputs in its pool, launches of a replay)``, the launches
    read from the graph's kernel nodes.  They must be exactly what the
    wrappers launched into the capture: else this raises."""
    _warm_up(fn, args)
    before = launch_counts()
    graph, out = _record(fn, args)
    launched = counts_delta(before, launch_counts())
    launches = launches_of(kernel_symbols(graph))
    if launches != launched:
        raise RuntimeError(f"the captured graph holds the kernels "
                           f"{launches}; the wrappers launched {launched} "
                           f"into it")
    return graph, out, launches


class SegmentRunner:
    """A segment function as CUDA graphs: one jitted runner of the JAX
    scheduler.  ``key`` is its (phase, n_steps, samplers, route); each new
    input ``signature`` captures a graph, as ``jax.jit`` traces one, so a
    graph's key is ``key + signature(args)``.  ``refresh()`` runs before
    every replay (the model's cast-once weights)."""

    def __init__(self, key: Tuple, fn: Callable,
                 refresh: Callable[[], Any] = lambda: None):
        self.key, self.fn, self.refresh = key, fn, refresh
        self.graphs: Dict[Tuple, Tuple] = {}
        self.capture_s = 0.0          # host seconds of warm-ups and captures
        self.replays = 0

    def __call__(self, *args):
        self.refresh()
        sig = signature(args)
        entry = self.graphs.get(sig)
        if entry is None:
            t0 = time.perf_counter()
            static = _map(torch.clone, args)
            entry = self.graphs[sig] = (static,) + capture(self.fn, *static)
            self.capture_s += time.perf_counter() - t0
        static, graph, out, launches = entry
        for s, x in zip(_leaves(static), _leaves(args)):
            if isinstance(s, torch.Tensor):
                s.copy_(x)
        graph.replay()
        _replayed(launches)
        self.replays += 1
        return _map(torch.clone, out)


class DecodeRunner:
    """``transformer.decode_step`` as a CUDA graph: the JAX launcher's
    ``jax.jit(decode_step)``.  Per config, batch and cache shape it holds
    one static cache set, a static token and a static 0-dim position, and
    one graph that reads the set and writes the step's new cache back into
    it (``decode_step(out=)`` on the set itself): an attention layer writes
    only its new row, at the position the graph reads from the device, so
    one graph serves every position and a step copies no cache.  Called as
    ``decode_step`` is, ``runner(cache, token, pos) -> (logits, cache)``:
    the cache returned is the set, which the next step updates in place.
    A decode starts from a cache the runner did not return (the prefill's,
    a fork), which is copied into the set and left as it is; the model's
    cast-once weights are refreshed then, so weights change between
    decodes, not within one.  Fed back the cache it returned, a step only
    fills the token and the position and replays.  The prefill stays
    eager (one call per prompt length)."""

    def __init__(self, model: tfm.LM):
        self.model = model
        self.graphs: Dict[Tuple, Tuple] = {}
        self.capture_s = 0.0
        self.replays = 0
        self._live = None                 # the graph of the decode under way

    def capture(self, cache: tfm.Cache, token) -> Tuple:
        """The model's cast-once weights refreshed, and the graph for
        ``cache`` and ``token``'s shapes, captured on first use: ``(cache
        set, static token, static position, (graph, (logits, cache),
        launches))``.  The warm-up and the capture run on the set, which
        the decode's first step then overwrites with its cache."""
        model = self.model
        model.cast_weights_()
        token = torch.as_tensor(token, dtype=torch.long, device=model.device)
        sig = (model.cfg,) + signature((cache, token))
        if sig not in self.graphs:
            t0 = time.perf_counter()
            cset = _map(torch.clone, cache)
            tok = token.clone()
            pos = torch.zeros((), dtype=torch.long, device=model.device)
            step = capture(
                lambda c, t, p: tfm.decode_step(model, c, t, p, out=c),
                cset, tok, pos)
            self.graphs[sig] = (cset, tok, pos, step)
            self.capture_s += time.perf_counter() - t0
        return self.graphs[sig]

    def __call__(self, cache: tfm.Cache, token, pos=None
                 ) -> Tuple[torch.Tensor, tfm.Cache]:
        if pos is None and tfm.uses_pos(self.model.cfg):
            raise ValueError(f"{self.model.cfg.name}'s decode step needs "
                             f"its position")
        live = self._live
        if live is None or cache is not live[0]:
            live = self._live = self.capture(cache, token)
            if cache is not live[0]:
                for s, x in zip(_leaves(live[0]), _leaves(cache)):
                    s.copy_(x)
        cset, tok, static_pos, (graph, (logits, _), launches) = live
        tok.copy_(token if isinstance(token, torch.Tensor)
                  else torch.as_tensor(token))
        static_pos.fill_(0 if pos is None else pos)
        graph.replay()
        _replayed(launches)
        self.replays += 1
        return logits.clone(), cset
