"""The benchmark of the PyTorch port: one cell (a configuration under a
traffic mix) a run, everything found by name.

* ``BENCHMARK.json`` names the cell's configuration, its traffic and the
  metrics it reports;
* ``configs/<config>.json`` holds the model, sampler and serving settings;
* ``workloads/<cell>.json`` the traffic mix: its loop (``offline`` or
  ``open``), the generators of ``traffic/`` it reads and their parameters,
  and the limits of the output check;
* ``metrics/<metric>.py`` one reader a metric, ``read(run) -> value or
  None``;
* ``reference/`` the plain float32 model and sampler that decide
  ``correct``.

The program (``src/repro_torch``) gives the system under test and its
counters; weights, prompts, arrivals and noise come from the seed, here.
"""
from __future__ import annotations

import collections
import gc
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from perfbench import weights as W
from perfbench.reference import model as ref_model

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
#: top-level modules that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_part(kind: str, name: str):
    """``perfbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One entry of ``workloads`` with its configuration and traffic files,
    and the metrics it reports."""
    name: str
    config: dict
    workload: dict
    end_to_end: List[str]
    per_layer: List[str]
    units: Dict[str, str]


def find_cell(name: str, bench: Optional[dict] = None) -> Cell:
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"]
                     if c["name"] == entry["config"])
    config = load_json(ROOT / cfg_entry["file"])
    workload = load_json(BENCH / "workloads" / f"{name}.json")
    e2e = [m["name"] for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    reported = set(e2e)
    layer = [m["name"] for m in bench["per_layer"]
             if name in m.get("workloads", [name] if m["moves"] in reported
                              else [])]
    units = {m["name"]: m["unit"]
             for m in bench["end_to_end"] + bench["per_layer"]}
    return Cell(name, config, workload, e2e, layer, units)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def span(name: str):
    """A host span the profiler records (near free when it is off)."""
    return torch.profiler.record_function(name)


# -- the system under test ------------------------------------------------------

class System:
    """The port's modules and serving engine for one configuration, with
    the weights of ``seed``; :meth:`reseed` loads another seed's weights in
    place (captured graphs stay valid)."""

    def __init__(self, config: dict, seed: int, device):
        from repro_torch.config import ModelConfig, SageConfig
        from repro_torch.models.dit import DiT
        from repro_torch.models.text_encoder import TextTower
        from repro_torch.models.vae import VAEDecoder
        from repro_torch.serving.engine import SageServingEngine

        self.config, self.device = config, torch.device(device)
        m, t = config["model"], config["text"]
        self.mcfg = ModelConfig(**m)
        self.tcfg = ModelConfig(name="text-tower", family="dense",
                                n_kv_heads=t["n_heads"], **t)
        gen = torch.Generator(device=self.device).manual_seed(0)
        self.dit = DiT(self.mcfg, device=self.device, generator=gen)
        self.text = TextTower(self.tcfg, device=self.device, generator=gen)
        self.vae = VAEDecoder(latent_channels=m["latent_channels"],
                              device=self.device, generator=gen,
                              dtype=getattr(torch, config["vae"]["dtype"]))
        self.seed = seed
        self.load_weights(seed)
        sage = config["sage"]
        srv = config["serving"]
        self.sage = SageConfig(**{k: v for k, v in sage.items()
                                  if k != "step_impl"})
        self.engine = SageServingEngine(
            self.sage, self.dit, self.text, self.vae,
            group_size=srv["group_size"], attn_impl=m["attn_impl"],
            step_impl=sage["step_impl"], policy=srv["policy"],
            noise_fn=self.noise, device=self.device)

    def noise(self, gid: int, shape) -> torch.Tensor:
        return W.group_noise(self.seed, gid, shape, self.device)

    def load_weights(self, seed: int) -> None:
        m, t = self.config["model"], self.config["text"]
        for mod, layout, stream in (
                (self.dit, ref_model.dit_shapes(m), W.DIT),
                (self.text, ref_model.text_shapes(t), W.TEXT),
                (self.vae, ref_model.vae_shapes(m["latent_channels"]),
                 W.VAE)):
            mod.load_state_dict(W.draw(layout, seed, stream, self.device),
                                strict=True)

    def reseed(self, seed: int) -> None:
        self.seed = seed
        self.load_weights(seed)


def n_graphs(sched) -> int:
    """CUDA graphs the scheduler's segment runners hold."""
    return sum(len(getattr(r, "graphs", ()))
               for r in sched._runners.values())


# -- the loops -------------------------------------------------------------------

@dataclass
class Request:
    prompt: str
    due: float                        # host clock when it was due
    done: float = math.nan            # host clock when its image came back
    gid: int = -1
    image: Optional[np.ndarray] = None
    latent: Optional[np.ndarray] = None   # what the VAE decoder was handed
    nfe_share: float = 0.0
    status: str = "pending"
    batch: int = -1                   # offline: the batch it rode


@dataclass
class Window:
    """What one measured window served and how."""
    t0: float
    t_last: float = 0.0               # the last image of the window's work
    requests: List[Request] = field(default_factory=list)
    batches: List[List[str]] = field(default_factory=list)
    stats: Dict[str, float] = field(default_factory=dict)
    captures: int = 0                 # graphs captured inside the window
    notes: Dict[str, Any] = field(default_factory=dict)
    #: seconds of set-up spent on the benchmark's own reference work,
    #: which ``setup_s`` leaves out
    reference_s: float = 0.0


class Decodes:
    """The latents the program hands its VAE decoder inside the window,
    caught by a forward hook on the decoder and found again by the first
    and last pixel of each image decoded from them, which the request's
    image carries: what the output check holds to the reference's latents,
    and the decoder's input when the check holds the decoder alone."""

    def __init__(self, vae):
        self.seen = []
        self.handle = vae.register_forward_hook(self._hook)

    def _hook(self, mod, args, out):
        key = torch.cat([out[:, 0, 0], out[:, -1, -1]], dim=-1)
        self.seen.append((args[0].detach().float().clone(),
                          key.detach().float()))

    def attach(self, requests: List["Request"]) -> None:
        """Give each served request the latent its image came from."""
        self.handle.remove()
        found = {}
        for z, key in self.seen:
            for zi, k in zip(z.cpu().numpy(), key.cpu().numpy()):
                found[k.tobytes()] = zi
        self.seen.clear()
        for r in requests:
            if r.image is not None:
                k = np.concatenate([r.image[0, 0], r.image[-1, -1]])
                r.latent = found.get(k.astype(np.float32).tobytes())


def _stats_delta(before: dict, after: dict) -> Dict[str, float]:
    return {k: after[k] - before.get(k, 0) for k in after}


def _record(req: Request, c, t: float) -> None:
    req.done, req.gid, req.nfe_share = t, c.group_id, c.nfe_share
    req.image, req.status = c.image, c.status


def group_counts(system: System, batches: List[List[str]]) -> List[int]:
    """How many groups each batch makes, by the reference's text tower and
    clique cover (float32 with TF32 off, on the device), with the seed's
    weights: the program's grouping agrees but where two similarities tie
    to rounding.  The program's TF32 settings are put back after."""
    from perfbench.reference import sampling as S
    cfg = system.config
    text = W.draw(ref_model.text_shapes(cfg["text"]), system.seed, W.TEXT,
                  system.device)
    out = []
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    ref_model.no_tf32()
    try:
        with torch.no_grad():
            for prompts in batches:
                _, pooled = ref_model.text_forward(
                    text, cfg["text"], ref_model.tokenize(
                        prompts, cfg["model"]["cond_len"], system.device))
                out.append(len(S.clique_groups(
                    S.similarity(pooled.cpu().numpy()),
                    cfg["sage"]["tau_min"], cfg["serving"]["group_size"])))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    return out


def offline_window(system: System, wl: dict, seconds: float, rng,
                   prof=None) -> Window:
    """A queue that never runs dry: ``engine.step(max_batch)`` over and
    over, each batch ``wl["batch"]`` fresh prompts; every batch begun
    before the window's end is finished and counted.  Set-up serves one
    batch, then one of each other count of groups the window's batches
    make; the reference's count of those groups is the benchmark's work,
    not the program's, and ``setup_s`` leaves it out
    (``Window.reference_s``)."""
    gen = load_part("traffic", wl["prompts"]["generator"])
    engine, B = system.engine, int(wl["batch"])
    t = time.perf_counter()
    warm = gen.prompts(wl["prompts"], rng, B)
    engine.submit(warm)
    engine.step(max_batch=B)
    sync(system.device)
    # the window's batches, drawn up front (more than it can begin), and a
    # warm-up batch for every count of groups among them: a batch of a
    # count the warm-up has not met would capture graphs in the window
    n = int(np.ceil(3 * seconds / (time.perf_counter() - t))) + 4
    batches = [gen.prompts(wl["prompts"], rng, B) for _ in range(n)]
    t_ref = time.perf_counter()
    counts = group_counts(system, [warm] + batches)
    sync(system.device)
    reference_s = time.perf_counter() - t_ref
    seen = {counts[0]}
    for prompts, k in zip(batches, counts[1:]):
        if k not in seen:
            seen.add(k)
            engine.submit(prompts)
            engine.step(max_batch=B)
    sync(system.device)
    todo = iter(batches)
    sched = engine.scheduler
    stats0, graphs0 = dict(engine.stats), n_graphs(sched)
    decodes = Decodes(system.vae)
    if prof is not None:
        prof.start()
    w = Window(t0=time.perf_counter(), reference_s=reference_s)
    with span("bench.window"):
        while not w.batches or time.perf_counter() - w.t0 < seconds:
            prompts = next(todo, None) or gen.prompts(wl["prompts"], rng, B)
            t_begin = time.perf_counter()
            with span("bench.submit"):
                engine.submit(prompts)
            with span("bench.step"):
                done = engine.step(max_batch=B)
            t_end = time.perf_counter()
            reqs = {}
            for p in prompts:
                reqs[p] = Request(p, t_begin, batch=len(w.batches))
            for c in done:
                _record(reqs[c.prompt], c, t_end)
            w.requests.extend(reqs.values())
            w.batches.append(prompts)
            w.t_last = t_end
    if prof is not None:
        prof.stop()
    decodes.attach(w.requests)
    w.stats = _stats_delta(stats0, engine.stats)
    w.captures = n_graphs(sched) - graphs0
    return w


def _idle(sched) -> bool:
    return not (sched.arrivals or sched.open_groups or sched.inflight)


def _drain(sched) -> None:
    while not _idle(sched):
        sched.tick()


def open_window(system: System, wl: dict, seconds: float, rng,
                prof=None) -> Window:
    """Poisson arrivals at the cell's fixed rate into a streaming scheduler
    on the wall clock: each due prompt is submitted as one request at the
    next turn of the loop, and the loop ticks while anything is pending.
    After the window nothing more is sent and the loop ticks on to drain,
    for at most ``wl["drain_cap_s"]`` seconds.  The window's counters
    (``Window.stats``) and the ``bench.load`` span, which a trace's
    device metrics read, end at its close, before the drain: the drain's
    falling load would read as smaller packs and a device more idle.  A
    traced run offers the load for ``wl["trace_s"]`` seconds only: a trace
    of the whole window holds millions of kernels, which take minutes to
    read, and a profiler started or stopped inside the loop holds the
    arrivals back for seconds."""
    if prof is not None:
        seconds = min(seconds, float(wl["trace_s"]))
    gen = load_part("traffic", wl["prompts"]["generator"])
    arr = load_part("traffic", wl["arrivals"]["generator"])
    sched = system.engine.streaming_scheduler(**wl["scheduler"])
    width = system.engine.group_size
    # every pack the window can make captured before it: a burst of G full
    # groups rides packs of G groups through each (phase, segment length)
    warm = gen.prompts(wl["prompts"], rng,
                       width * int(wl["warm_groups"]) * 2)
    for g in range(1, int(wl["warm_groups"]) + 1):
        sched.submit(warm[:width * g])
        warm = warm[width * g:]
        _drain(sched)
    sync(system.device)
    offsets = arr.arrivals(wl["arrivals"], rng, seconds)
    prompts = gen.prompts(wl["prompts"], rng, len(offsets))
    stats0, graphs0 = dict(sched.stats), n_graphs(sched)
    by_prompt: Dict[str, collections.deque] = collections.defaultdict(
        collections.deque)
    decodes = Decodes(system.vae)
    if prof is not None:
        prof.start()
    w = Window(t0=time.perf_counter())
    t0m = time.monotonic() - (time.perf_counter() - w.t0)
    due = t0m + offsets
    w.requests = [Request(p, w.t0 + o) for p, o in zip(prompts, offsets)]
    late, i, n = [], 0, len(offsets)
    cap = seconds + float(wl["drain_cap_s"])
    load = span("bench.load")
    closed = {}

    def close():
        """The window's end: the load stops and its counters are read."""
        if not closed:
            load.__exit__(None, None, None)
            closed.update(sched.stats)
            w.notes["pending_at_close"] = sched.pending

    with span("bench.window"):
        load.__enter__()
        while True:
            now = time.monotonic()
            if i < n and due[i] <= now:
                j = np.searchsorted(due, now, side="right")
                with span("bench.submit"):
                    sched.submit(prompts[i:j], now=now)
                late.extend(now - due[i:j])
                for k in range(i, j):
                    by_prompt[prompts[k]].append(k)
                i = j
            if now - t0m >= seconds:
                close()
            if not _idle(sched):
                with span("bench.tick"):
                    out = sched.tick(now=time.monotonic())
                t = time.perf_counter()
                for c in out:
                    _record(w.requests[by_prompt[c.prompt].popleft()], c, t)
                    w.t_last = t
            elif i < n:
                with span("bench.wait"):
                    time.sleep(max(0.0, min(due[i] - time.monotonic(),
                                            0.05)))
            else:
                break
            if now - t0m > cap:
                break
        close()
    if prof is not None:
        prof.stop()
    decodes.attach(w.requests)
    w.notes["pending_at_end"] = sched.pending
    w.stats = _stats_delta(stats0, closed)
    w.notes["completed_in_drain"] = (sched.stats["completed"]
                                     - closed["completed"])
    w.captures = n_graphs(sched) - graphs0
    if late:
        a = np.asarray(late)
        w.notes["lateness_ms"] = {"p50": float(np.percentile(a, 50) * 1e3),
                                  "p99": float(np.percentile(a, 99) * 1e3),
                                  "max": float(a.max() * 1e3)}
    return w


LOOPS = {"offline": offline_window, "open": open_window}


def group_sizes(w: Window) -> Dict[int, int]:
    """Histogram of the served groups' sizes."""
    members = collections.Counter(r.gid for r in w.requests if r.gid >= 0)
    return dict(sorted(collections.Counter(members.values()).items()))


def served(r: Request) -> bool:
    return (r.status == "ok" and r.image is not None
            and bool(np.isfinite(r.image).all()))


# -- a whole run -------------------------------------------------------------------

@dataclass
class Run:
    """What the metric readers read."""
    cell: Cell
    window: Window
    setup_s: float
    trace: Optional[Any] = None       # perfbench.devtrace.Trace
    device_kind: str = ""


def built_seconds() -> float:
    """Seconds this process spent building the port's kernels (0 where the
    build was there already, or nothing was built)."""
    from repro_torch.kernels import _build
    return float(getattr(_build, "last_build_seconds", None) or 0.0)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def hooks(system: System) -> List[Any]:
    """Host spans around the text tower and the VAE decoder, for naming the
    device's idle gaps in a traced run."""
    handles = []
    for mod, name in ((system.text, "bench.embed"),
                      (system.vae, "bench.decode")):
        def pre(m, args, name=name):
            m._bench_span = span(name)
            m._bench_span.__enter__()

        def post(m, args, out):
            m._bench_span.__exit__(None, None, None)
        handles += [mod.register_forward_pre_hook(pre),
                    mod.register_forward_hook(post)]
    return handles


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> Dict[str, Any]:
    """Set up, measure one window, check what it served, and return the
    result line's object (``correct`` .. ``compared``)."""
    from perfbench import check, devtrace as tr
    dev = torch.device(device)
    wl = cell.workload
    rng = np.random.default_rng([seed & (2 ** 64 - 1), 7])
    system = System(cell.config, seed, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    prof = None
    handles = []
    if trace:
        handles = hooks(system)
        prof = tr.profiler(dev)
    # set-up ends where the window begins: the loop's own warm-up counts,
    # the benchmark's reference work does not
    w = LOOPS[wl["loop"]](system, wl, seconds, rng, prof=prof)
    setup_s = w.t0 - t_start - w.reference_s
    build_s = built_seconds()
    for h in handles:
        h.remove()
    mem = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
           else 0)
    summary = tr.summarize(prof, w) if prof is not None else None
    run = Run(cell, w, setup_s, summary,
              torch.cuda.get_device_name(dev) if dev.type == "cuda" else
              "cpu")
    metrics = {}
    for name in (cell.per_layer if trace else cell.end_to_end):
        value = load_part("metrics", name).read(run)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": cell.units[name]}
    attempted = len(w.requests)
    failed = sum(not served(r) for r in w.requests)
    log(f"[bench] {cell.name} seed={seed} window_s={w.t_last - w.t0:.4f} "
        f"setup_s={setup_s:.4f} reference_s={w.reference_s:.4f} "
        f"built={build_s > 0} build_s={build_s:.4f} "
        f"requests={attempted} failed={failed} "
        f"batches={len(w.batches)} captures_in_window={w.captures} "
        f"group_sizes={group_sizes(w)} stats={w.stats} notes={w.notes}")
    result = {"correct": False, "attempted": attempted, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                         "kind": run.device_kind, "count": 1,
                         "memory_peak_bytes": int(mem)}}
    if summary is not None:
        result["device"]["busy_s"] = summary.busy_s
        result["device"]["window_s"] = summary.window_s
        result["breakdown"] = summary.breakdown()
    # a checkout's first run builds the kernels inside its set-up
    result["built"] = build_s > 0
    # the program's state goes before the reference runs
    system_config = system.config
    del system
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = check.judge(system_config, wl, w, seed, dev)
    log(f"[bench] check_s={time.perf_counter() - t_check:.4f}")
    result["correct"] = check.passed(numbers)
    result["compared"] = numbers
    return result
