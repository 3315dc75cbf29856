"""Multi-pod dry run: every (arch x shape) built fully sharded on the
production mesh and run once on fake tensors; per-device FLOPs, bytes,
collective bytes and memory, and the roofline terms.  The twin of the
JAX package's ``launch/dryrun.py``, flags and JSON included.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod

One JSON per case lands in ``experiments/dryrun_torch/``, with the JAX
dry run's keys; ``python -m repro_torch.launch.roofline`` renders them.

No card is needed, as the JAX dry run runs on host devices: a ``fake``
process group of 256 (16x16) or 512 (2x16x16) ranks, a ``DeviceMesh`` of
the CPU device type over it, and the case's tensors made under
``FakeTensorMode`` (DTensors of fake local shards: nothing is allocated,
no collective moves a byte, nothing is launched).  The step runs eagerly
once as rank 0 of the group, so every layer is seen and the full config
is counted at full depth: no k1/k2 extrapolation, which the JAX dry run
needs because XLA counts a scanned body once.

What one rank does, from the local ops (:class:`LocalCounter`, a
``TorchDispatchMode`` that lets DTensor desugar each op into its local
op and collectives, and counts those):

* FLOPs: ``torch.utils.flop_counter``'s formulas (mm, bmm, addmm,
  baddbmm, convolution, SDPA and their backwards) on the local shapes;
* bytes: the input and output bytes of every local op that is not a
  view: an unfused count, where XLA's "bytes accessed" is after fusion;
* collective bytes: the output bytes of each ``_c10d_functional``
  collective (and DTensor's all-to-all), under the JAX kinds
  (:data:`COLLECTIVE_KINDS`);
* memory: the arguments' local bytes, the outputs', and the peak of the
  local storages live during the step less the arguments.

DTensor chooses its own redistributions (it may all-gather a weight
sharded on a contraction dim where XLA keeps partial sums), so the
collective bytes and FLOPs are DTensor's, not XLA's; the argument bytes
are set by the specs alone and equal the JAX dry run's.  DTensor's
plans also change with torch's version, so a count holds for the torch
that made it (each result line prints it); a case in which a sharded op
found no plan at all and ran whole on every rank is refused
(``specs.Fallbacks``).

The roofline terms take the NVIDIA H100 SXM's datasheet figures at
700 W (``launch/costs.py``): bf16 dense peak, HBM3, NVLink (per
direction) where the JAX dry run has the TPU's ICI.  A 16-wide
``model`` axis spans two 8-GPU NVLink nodes, so the NVLink term is a
floor.  These are predictions, not measurements.

The ``kernel`` attention route is refused: no kernel runs on fake
tensors, and its plain twin is not the kernel.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import time
import traceback
import weakref
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import tree as tu
from repro_torch.config import SHAPES, get_config
from repro_torch.launch import specs
from repro_torch.launch.costs import HBM_BW, NVLINK_BW, PEAK_FLOPS
from repro_torch.launch.specs import build_case

#: ``_c10d_functional`` collectives by the JAX dry run's kind names
COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-permute",
}
#: ops that move no bytes: views are ``func.is_view``; these besides
#: (``_unsafe_view`` is a view autograd treats as new; ``prim.device`` a
#: query that fake tensors dispatch)
_FREE = ("detach", "alias", "lift_fresh", "empty", "empty_like",
         "empty_strided", "new_empty", "new_empty_strided", "wait_tensor",
         "_wrap_tensor_autograd", "_unsafe_view", "device")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    return [x for x in torch.utils._pytree.tree_leaves(tree)
            if isinstance(x, torch.Tensor)]


def local_bytes(tree) -> int:
    """The bytes of ``tree``'s tensors on this rank (a DTensor's local
    shard)."""
    from torch.distributed.tensor import DTensor
    return sum(_nbytes(x.to_local() if isinstance(x, DTensor) else x)
               for x in tu.leaves(tree) if isinstance(x, torch.Tensor))


class LocalCounter(TorchDispatchMode):
    """Counts what this rank runs: DTensor's ops are let through
    (``NotImplemented``) so that each comes back as its local op and its
    collectives, and those are counted (module docstring).  A view that
    cannot be taken of a local shard's layout (DTensor can hand an
    einsum's reshape a view its permuted shard cannot give) is taken of
    a contiguous copy, the copy counted."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flops_of = flop_registry
        self.flops = 0
        self.flops_by_op: Dict[str, int] = {}
        self.bytes = 0
        self.coll: Dict[str, int] = {}
        self.live = 0
        self.peak = 0
        self._storages = set()

    def hold(self, tree) -> int:
        """Count ``tree``'s local storages as live (the arguments); returns
        their bytes."""
        from torch.distributed.tensor import DTensor
        before = self.live
        for x in tu.leaves(tree):
            if isinstance(x, torch.Tensor):
                self._track(x.to_local() if isinstance(x, DTensor) else x)
        self.peak = max(self.peak, self.live)
        return self.live - before

    def _free(self, key: int, n: int) -> None:
        self._storages.discard(key)
        self.live -= n

    def _track(self, t: torch.Tensor, own: bool = False) -> None:
        """Count ``t``'s storage as live until it is freed; ``own``: count
        only ``t``'s bytes (a collective's output, whose fake storage can
        be the whole gathered tensor it was cut from)."""
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return
        n = _nbytes(t) if own else st.nbytes()
        self._storages.add(key)
        self.live += n
        weakref.finalize(st, self._free, key, n)

    def _run(self, func, args, kwargs):
        out = func(*args, **kwargs)
        name = func.__name__.split(".")[0]
        collective = func.namespace in ("_c10d_functional", "_dtensor")
        if collective:
            kind = COLLECTIVE_KINDS.get(name)
            if kind is not None:
                n = sum(_nbytes(t) for t in _tensors(out))
                self.coll[kind] = self.coll.get(kind, 0) + n
        elif not (func.is_view or name in _FREE):
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.bytes += sum(_nbytes(t) for t in _tensors(out))
        fn = self._flops_of.get(func._overloadpacket)
        if fn is not None:
            n = fn(*args, **kwargs, out_val=out)
            self.flops += n
            self.flops_by_op[name] = self.flops_by_op.get(name, 0) + n
        if not func.is_view:
            for t in _tensors(out):
                self._track(t, own=collective)
            self.peak = max(self.peak, self.live)
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        try:
            return self._run(func, args, kwargs)
        except (RuntimeError, ValueError):
            if func is not torch.ops.aten.view.default:
                raise
        copy = self._run(torch.ops.aten.clone.default, (args[0],),
                         {"memory_format": torch.contiguous_format})
        return self._run(torch.ops.aten._unsafe_view.default,
                         (copy,) + tuple(args[1:]), kwargs)

    def collectives(self) -> Dict[str, int]:
        out = dict(self.coll)
        out["total"] = sum(out.values())
        return out


def collective_bytes(fn, *args, **kwargs) -> Dict[str, int]:
    """Per-device output bytes of every collective that ``fn(*args,
    **kwargs)`` issues, by kind, and their ``total``."""
    with LocalCounter() as c:
        fn(*args, **kwargs)
    return c.collectives()


def count_step(case: specs.DryrunCase) -> Dict[str, Any]:
    """Run ``case.fn(*case.args)`` once under a :class:`LocalCounter`:
    the rank's FLOPs (also by op: ``flops_by_op``), bytes, collective
    bytes, memory analysis (JAX's keys), the outputs and the seconds."""
    counter = LocalCounter()
    args_b = counter.hold(case.args)
    t0 = time.perf_counter()
    with counter:
        out = case.fn(*case.args)
    dt = time.perf_counter() - t0
    return {"flops": counter.flops, "flops_by_op": counter.flops_by_op,
            "bytes": counter.bytes,
            "coll": counter.collectives(), "seconds": dt, "out": out,
            "memory_analysis": {
                "argument_size_in_bytes": args_b,
                "output_size_in_bytes": local_bytes(out),
                "temp_size_in_bytes": counter.peak - args_b,
                "generated_code_size_in_bytes": 0}}


@contextlib.contextmanager
def fake_group(world: int):
    """A ``fake`` default process group of ``world`` ranks (this process
    is rank 0) for the block, destroyed after it.  A default group of
    ``world`` ranks that already exists is used as it is and kept; one of
    another size raises."""
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(
                f"the dry run needs a default process group of {world} "
                f"ranks; one of {dist.get_world_size()} exists")
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def measure(arch: str, shape_name: str, mesh, smoke: bool = False,
            kw: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Build one case on ``mesh`` under ``FakeTensorMode`` and count its
    step (:func:`count_step`); also the ``case`` and the names of the ops
    that took ``specs.dtensor_rules``' fallback (``fallbacks``).  Raises
    if a sharded op found no plan and ran whole on every rank
    (``specs.Fallbacks.refuse_whole``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    kw = dict(kw or {})
    if kw.get("attn_impl") == "kernel":
        raise ValueError(
            "the dry run runs on fake tensors, where no kernel runs: the "
            "'kernel' attention route cannot be counted")
    with FakeTensorMode(allow_non_fake_inputs=True), \
            specs.dtensor_rules() as fallbacks:
        case = build_case(arch, shape_name, mesh, smoke=smoke, **kw)
        res = count_step(case)
    fallbacks.refuse_whole()
    res.update(case=case, fallbacks=sorted(fallbacks.taken))
    return res


def _n_blocks_full(cfg) -> int:
    per = len(cfg.pattern) if cfg.pattern else 1
    prefix = cfg.moe.first_moe_layer if cfg.family == "moe" else 0
    return (cfg.n_layers - prefix - len(cfg.remainder)) // per


# §Perf hillclimb variants: name -> builder kwargs
VARIANTS = {
    "chunked": {"attn_impl": "chunked"},          # online-softmax attention
    "chunked4k": {"attn_impl": "chunked", "attn_block": 4096},
    "chunked8k": {"attn_impl": "chunked", "attn_block": 8192},
    "chunked512": {"attn_impl": "chunked", "attn_block": 512},
    "dp_only": {"no_tp": True},                   # replicate params (sage)
    "seqshard": {"cache_seq_shard": True},        # KV cache seq over model
    "chunked_seqshard": {"attn_impl": "chunked", "cache_seq_shard": True},
    "adafactor": {"optim": "adafactor"},          # factored opt state
    "noremat": {"remat": False},
    "chunked_noremat": {"attn_impl": "chunked", "remat": False},
}


def model_flops(cfg, shape_name: str, static: Dict[str, Any]) -> float:
    """The JAX dry run's useful-FLOP count of one step, over all devices."""
    if shape_name == "sage_serve":
        K, N = static["batch"], static["seq"]
        n_lat = (cfg.latent_size // cfg.patch) ** 2
        token_passes = 2 * (K + K * N) * n_lat          # CFG doubles evals
        return 2.0 * cfg.n_params() * token_passes
    shape = SHAPES[shape_name]
    tokens = shape.global_batch * (shape.seq_len
                                   if shape.kind != "decode" else 1)
    flops = 6.0 * cfg.n_active_params() * tokens
    if shape.kind == "train":
        flops *= 3.0  # fwd + bwd
    return flops


def run_case(arch: str, shape_name: str, multi_pod: bool, smoke: bool = False,
             outdir: str = "experiments/dryrun_torch", variant: str = "",
             builder_kw=None):
    """One case on the production mesh (a fake group of 256 or 512 ranks,
    made and destroyed here): the full config counted at full depth,
    written as ``outdir/<arch>_<shape>_<mesh>[_<variant>].json``."""
    from repro_torch.launch.mesh import make_production_mesh
    kw = dict(VARIANTS.get(variant, {}))
    kw.update(builder_kw or {})
    cfg = get_config(arch, smoke=smoke)
    n_chips = 512 if multi_pod else 256
    with fake_group(n_chips):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        m = measure(arch, shape_name, mesh, smoke, kw)
    flops, bytes_acc, coll = m["flops"], m["bytes"], m["coll"]
    case = m["case"]
    mf = model_flops(cfg, shape_name, case.static)
    res = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": int(n_chips), "variant": variant or "baseline",
        "compile_s": round(m["seconds"], 2),
        "full_scan_compile_s": round(m["seconds"], 2),
        "flops_per_dev": float(flops), "bytes_per_dev": float(bytes_acc),
        "collective_bytes_per_dev": coll,
        "compute_term_s": flops / PEAK_FLOPS,
        "memory_term_s": bytes_acc / HBM_BW,
        "collective_term_s": coll["total"] / NVLINK_BW,
        "model_flops_global": mf,
        "useful_flops_ratio": (mf / (flops * n_chips) if flops else 0.0),
        "memory_analysis": m["memory_analysis"],
        "static": case.static,
    }
    terms = {"compute": res["compute_term_s"], "memory": res["memory_term_s"],
             "collective": res["collective_term_s"]}
    res["bottleneck"] = max(terms, key=terms.get)

    pathlib.Path(outdir).mkdir(parents=True, exist_ok=True)
    tag = f"{arch}_{shape_name}_{res['mesh']}"
    if variant:
        tag += f"_{variant}"
    with open(f"{outdir}/{tag}.json", "w") as f:
        json.dump(res, f, indent=1)
    mem = res["memory_analysis"]
    gib = (mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]) / 2**30
    print(f"[dryrun] {tag}: step={m['seconds']:.1f}s "
          f"flops/dev={flops:.3e} bytes/dev={bytes_acc:.3e} "
          f"coll/dev={coll['total']:.3e} bottleneck={res['bottleneck']} "
          f"mem/dev={gib:.2f}GiB fallbacks={m['fallbacks']} "
          f"torch={torch.__version__}")
    print(f"  memory_analysis: {res['memory_analysis']}")
    return res


def main(argv=None):
    from repro_torch.configs import ASSIGNED
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(SHAPES) + ["sage_serve", None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--variant", default="")
    ap.add_argument("--fast", action="store_true",
                    help="full config only (the only thing this dry run "
                         "measures; kept for the JAX CLI)")
    args = ap.parse_args(argv)

    archs = ASSIGNED if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]

    failures = []
    for arch in archs:
        for shape in shapes:
            tag = f"{arch}_{shape}"
            out = pathlib.Path(args.out) / (
                f"{arch}_{shape}_{'2x16x16' if args.multi_pod else '16x16'}"
                + (f"_{args.variant}" if args.variant else "") + ".json")
            if args.all and out.exists():
                print(f"[dryrun] skip existing {out}")
                continue
            try:
                run_case(arch, shape, args.multi_pod, smoke=args.smoke,
                         outdir=args.out, variant=args.variant)
            except Exception as e:  # noqa: BLE001 (report, go on)
                failures.append((tag, repr(e)))
                print(f"[dryrun] FAIL {tag}: {e}")
                traceback.print_exc()
    if failures:
        print(f"[dryrun] {len(failures)} failures:")
        for t, e in failures:
            print(" ", t, e[:200])
        raise SystemExit(1)
    print("[dryrun] all cases OK")


if __name__ == "__main__":
    main()
