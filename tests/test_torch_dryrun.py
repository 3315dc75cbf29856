"""The port's dry run (``repro_torch.launch.specs`` / ``dryrun``) held to
the JAX package's: ``n_active_params`` for every registered config,
``scale_config`` and ``_n_blocks_full`` for every assigned arch, the
dry run's JSON keys (read from the JAX module's source: importing it sets
``XLA_FLAGS``) and its model-FLOP formula, at smoke size on a fake 16x16
group: a train (dense), a prefill (MoE), a decode (SSM) and the SAGE
step.  Also: the FLOP count is linear in the blocks exactly (the JAX dry
run's k1/k2 extrapolation), the collective bytes of known
redistributions, and the refusals.  Every process group made here is
destroyed.

Against XLA's own numbers: in a child process with 512 host devices
(the JAX dry run's count), the JAX builders' phi3 ``train_4k``,
``sage_serve`` and three ``prefill_32k`` cases whose heads outnumber the
16-wide ``model`` axis while their KV heads do not (GQA, MQA and the
hybrid's local attention with its ring write) at smoke size are compiled
on a 16x16 mesh of Auto axes (jax 0.9's ``make_mesh`` gives Explicit
axes, on which ``repro.launch.dryrun.run_case`` raises
``ShardingTypeError``), and their ``memory_analysis``, ``cost_analysis``
and partitioned HLO read back.  The port's runs of the same cases on a
fake 16x16 group must match the argument bytes and the dots' FLOPs a
device exactly, and ``cost_analysis``'s FLOPs within a band;
``repro_torch.launch.roofline`` must print what ``repro.launch.roofline``
prints over the port's JSONs, in both views.  Also the module's own
DTensor plans that hold on every torch version: a ring write's
``index_put_`` in both forms torch hands it over, head splits wider than
the KV heads, a partial input to a pointwise op."""
import ast
import contextlib
import dataclasses
import io
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from repro.config import get_config as jax_get_config
from repro.config import list_archs as jax_list_archs
from repro.configs import ASSIGNED
from repro.launch import specs as jax_specs
from repro_torch import tree as tu
from repro_torch.config import get_config, list_archs
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import make_production_mesh

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: one case of each kind over the dense, MoE and SSM families and SAGE
CASES = (("phi3-mini-3.8b", "train_4k"),
         ("deepseek-v2-lite-16b", "prefill_32k"),
         ("mamba2-780m", "decode_32k"),
         ("sage-dit", "sage_serve"),
         # its backward transposes an activation strided over both mesh
         # dims (the batch over ``data``, the sequence over ``model``)
         ("granite-20b", "train_4k"))
#: what granite-20b ``train_4k --smoke`` counts a device on torch 2.13
#: (``chip_smoke.DRYRUN_EXPECTED`` holds the card's torch to the same)
#: the weight gradient of that chain (``test_a_strided_transpose_...``):
#: a local (256, 4096) x (4096, 256) product, after the output gradient's
#: rows of one ``data`` shard are gathered over ``model`` (65536 x 256
#: bf16) and cut to the transpose's strided rows
GRANITE_GRAD_W_FLOPS = 2 * 256 * 4096 * 256
GRANITE_GRAD_W_COLLECTIVES = {"all-gather": 65536 * 256 * 2,
                              "total": 65536 * 256 * 2}
GRANITE_TRAIN_SMOKE_COUNTS = {
    "flops_per_dev": 181462368256.0,
    "collective_bytes_per_dev": {
        "all-gather": 1517936640, "all-to-all": 1093713920,
        "reduce-scatter": 7191552, "all-reduce": 10304,
        "total": 2618852416}}


#: the cases compiled by XLA, ``arch:shape[:tag]``, with the builder
#: keywords of both sides: the JAX DiT scans its blocks
#: (``repro/models/dit.py``'s ``lax.scan``, which ``unroll`` does not
#: reach) and XLA's cost analysis counts a loop body once, so at the smoke
#: depth of 2 blocks XLA counts one (the port's count was 1.80x XLA's
#: there); at 1 block both count the whole step.  ``heads`` replaces
#: (n_heads, n_kv_heads, head_dim) of the smoke config on both sides, so
#: that fewer KV heads than the 16-wide ``model`` axis meet more query
#: heads: a GQA prefill (32 / 8), an MQA one (32 / 1) and the hybrid's
#: local attention with its ring write (16 / 1)
XLA_CASES = {"phi3-mini-3.8b:train_4k": {},
             "sage-dit:sage_serve": {"n_blocks": 1},
             "qwen3-32b:prefill_32k:gqa": {"heads": [32, 8, 32]},
             "granite-20b:prefill_32k:mqa": {"heads": [32, 1, 64]},
             "recurrentgemma-2b:prefill_32k:ring": {"heads": [16, 1, 128]}}
#: port / XLA per-device FLOPs (``cost_analysis``), measured: 0.838
#: (phi3), 0.683 (sage, 25,477,120 / 37,293,092), 0.924 (gqa), 0.960
#: (mqa) and 0.966 (ring).  The port counts the matmuls (and
#: convolutions) only (``torch.utils.flop_counter``), and its matmuls
#: equal the FLOPs of the dots in XLA's partitioned HLO exactly (checked
#: below); XLA also counts the elementwise ops, reductions and
#: transcendentals, which at the smoke width (d_model 128) are 32% of
#: sage's step, hence sage's band below 0.75
#: recurrentgemma's own heads (10, 1 KV head): XLA splits the heads 2
#: ways and replicates them over the rest of the 16-wide axis; the port
#: splits the query sequence 16 ways (no plan of DTensor's splits 10
#: heads), so it computes and holds less than XLA there
XLA_FINER = {"recurrentgemma-2b:prefill_32k:ten": {"heads": [10, 1, 128]}}
FLOP_BANDS = {"phi3-mini-3.8b:train_4k": (0.75, 1.25),
              "sage-dit:sage_serve": (0.683 * 0.75, 1.25),
              "qwen3-32b:prefill_32k:gqa": (0.75, 1.25),
              "granite-20b:prefill_32k:mqa": (0.75, 1.25),
              "recurrentgemma-2b:prefill_32k:ring": (0.75, 1.25)}

XLA_SIDE = r"""
import dataclasses, json, math, os, re, sys
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=512")
import jax
from jax.sharding import AxisType
from repro.launch import specs
mesh = jax.make_mesh((16, 16), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2,
                     devices=jax.devices()[:256])
config = specs.get_config
out = {}
for name, kw in json.loads(sys.argv[1]).items():
    arch, shape = name.split(":")[:2]
    kw = dict(kw)
    heads = kw.pop("heads", None)
    specs.get_config = (config if heads is None else
                        lambda arch, smoke=False: dataclasses.replace(
                            config(arch, smoke=smoke), n_heads=heads[0],
                            n_kv_heads=heads[1], head_dim=heads[2]))
    case = specs.build_case(arch, shape, mesh, smoke=True, unroll=True,
                            **kw)
    with mesh:
        c = jax.jit(case.fn, donate_argnums=case.static.get("donate", ())
                    ).lower(*case.args).compile()
    cost = c.cost_analysis()
    cost = cost[0] if isinstance(cost, (list, tuple)) else cost
    hlo = c.as_text()
    shapes = dict((m[0], [int(d) for d in m[1].split(",") if d])
                  for m in re.findall(r"%?([\w.-]+) = \w+\[([\d,]*)\]", hlo))
    dots = 0
    for o, a, k in re.findall(r"%?([\w.-]+) = \w+\[[\d,]*\]\S* "
                              r"dot\(%?([\w.-]+), [^)]*\).*?"
                              r"lhs_contracting_dims=\{([\d,]*)\}", hlo):
        dots += 2 * math.prod(shapes[o]) * math.prod(
            shapes[a][int(i)] for i in k.split(",") if i)
    # the only convolutions are depthwise (the RG-LRU's causal conv),
    # left out on both sides: the dots are every product
    assert all("feature_group_count=" in line for line in hlo.splitlines()
               if " convolution(" in line)
    out[name] = {
        "flops": float(cost["flops"]), "dot_flops": dots,
        "argument_size_in_bytes": c.memory_analysis().argument_size_in_bytes,
        "temp_size_in_bytes": c.memory_analysis().temp_size_in_bytes}
print(json.dumps(out))
"""


def _jax_result_keys():
    """The keys of the JAX dry run's result dict (``res`` in ``run_case``,
    plus ``bottleneck``), from its source."""
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == "run_case")
    for node in ast.walk(fn):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and getattr(node.targets[0], "id", "") == "res"):
            keys = {k.value for k in node.value.keys}
    return keys | {"bottleneck"}


def _jax_n_blocks_full(cfg):
    """``repro.launch.dryrun._n_blocks_full`` (that module is not imported:
    it sets XLA_FLAGS)."""
    per = len(cfg.pattern) if cfg.pattern else 1
    prefix = cfg.moe.first_moe_layer if cfg.family == "moe" else 0
    return (cfg.n_layers - prefix - len(cfg.remainder)) // per


def _jax_model_flops(arch, shape_name, static):
    """``repro.launch.dryrun.run_case``'s model-FLOP formula on the JAX
    config."""
    from repro.config import SHAPES as JAX_SHAPES
    cfg = jax_get_config(arch, smoke=True)
    if shape_name == "sage_serve":
        K, N = static["batch"], static["seq"]
        n_lat = (cfg.latent_size // cfg.patch) ** 2
        return 2.0 * cfg.n_params() * 2 * (K + K * N) * n_lat
    s = JAX_SHAPES[shape_name]
    tokens = s.global_batch * (s.seq_len if s.kind != "decode" else 1)
    mf = 6.0 * cfg.n_active_params() * tokens
    return mf * 3.0 if s.kind == "train" else mf


@pytest.mark.parametrize("arch", sorted(jax_list_archs()))
def test_n_active_params_equals_jax(arch):
    assert sorted(list_archs()) == sorted(jax_list_archs())
    assert (get_config(arch).n_active_params()
            == jax_get_config(arch).n_active_params())


@pytest.mark.parametrize("arch", ASSIGNED)
def test_scale_config_and_n_blocks_equal_jax(arch):
    for nb in (1, 2, 5):
        got = specs.scale_config(get_config(arch), nb)
        want = jax_specs.scale_config(jax_get_config(arch), nb)
        assert (got.n_layers, got.enc_layers) == (want.n_layers,
                                                  want.enc_layers)
        assert dryrun._n_blocks_full(got) == _jax_n_blocks_full(want) == nb
    assert (dryrun._n_blocks_full(get_config(arch))
            == _jax_n_blocks_full(jax_get_config(arch)))


@contextlib.contextmanager
def _heads(heads):
    """``specs.build_case`` on smoke configs whose (n_heads, n_kv_heads,
    head_dim) are ``heads`` (as the XLA child replaces them), for the
    block."""
    config = specs.get_config
    if heads is not None:
        specs.get_config = lambda arch, smoke=False: dataclasses.replace(
            config(arch, smoke=smoke), n_heads=heads[0],
            n_kv_heads=heads[1], head_dim=heads[2])
    try:
        yield
    finally:
        specs.get_config = config


def _measure_xla_case(case, mesh):
    """The port's matmul FLOPs a device (its convolutions, which XLA's
    dots leave out, excluded), argument bytes, FLOPs and temporary bytes
    of an XLA case."""
    kw = dict({**XLA_CASES, **XLA_FINER}[case])
    arch, shape = case.split(":")[:2]
    with _heads(kw.pop("heads", None)):
        m = dryrun.measure(arch, shape, mesh, smoke=True, kw=kw)
    mem = m["memory_analysis"]
    return (m["flops"] - m["flops_by_op"].get("convolution", 0),
            mem["argument_size_in_bytes"], m["flops"],
            mem["temp_size_in_bytes"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The smoke cases run once each on a fake 16x16 group (as
    ``run_case``), phi3 ``train_4k`` at 1 and 3 blocks (its
    smoke config has 2) and the SAGE step at 1 block; meanwhile XLA's
    numbers of :data:`XLA_CASES`, in a child process (``xla``)."""
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    child = subprocess.Popen(
        [sys.executable, "-c", XLA_SIDE,
         json.dumps({**XLA_CASES, **XLA_FINER})], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        res = {"dir": str(out)}
        for arch, shape in CASES:
            res[arch, shape] = dryrun.run_case(arch, shape, False,
                                               smoke=True, outdir=str(out))
        # a variant's JSON for the roofline's variants view
        variant = dict(res["sage-dit", "sage_serve"], variant="dp_only")
        (out / "sage-dit_sage_serve_16x16_dp_only.json").write_text(
            json.dumps(variant))
        with dryrun.fake_group(256):
            mesh = make_production_mesh(device_type="cpu")
            res["blocks"] = {nb: dryrun.measure(
                "phi3-mini-3.8b", "train_4k", mesh, smoke=True,
                kw={"n_blocks": nb})["flops"] for nb in (1, 3)}
            res["port"] = {case: _measure_xla_case(case, mesh)
                           for case in {**XLA_CASES, **XLA_FINER}}
        res["blocks"][2] = res["phi3-mini-3.8b", "train_4k"]["flops_per_dev"]
        assert not dist.is_initialized()
        stdout, stderr = child.communicate(timeout=600)
    finally:
        child.kill()
    assert child.returncode == 0, stderr[-3000:]
    res["xla"] = json.loads(stdout.strip().splitlines()[-1])
    return res


@pytest.mark.parametrize("case", CASES)
def test_smoke_run_keys_and_model_flops_equal_jax(runs, case):
    res = runs[case]
    assert set(res) == _jax_result_keys()
    assert res["model_flops_global"] == _jax_model_flops(*case,
                                                         res["static"])
    assert res["chips"] == 256 and res["mesh"] == "16x16"
    assert res["flops_per_dev"] > 0 and res["bytes_per_dev"] > 0
    mem = res["memory_analysis"]
    assert mem["argument_size_in_bytes"] > 0
    assert mem["temp_size_in_bytes"] >= 0
    assert res["bottleneck"] in ("compute", "memory", "collective")
    assert res["collective_bytes_per_dev"]["total"] == sum(
        v for k, v in res["collective_bytes_per_dev"].items()
        if k != "total")


def test_granite_train_smoke_counts_as_recorded(runs):
    """granite-20b ``train_4k --smoke`` (4 heads, which the 16-wide
    ``model`` axis cannot split: its head split takes the view fallback)
    runs through ``dryrun.measure`` and counts what torch 2.13 counted
    when the repair of its strided transpose was made (the same as
    before it: the rule is 2.13's own)."""
    res = runs["granite-20b", "train_4k"]
    got = {k: res[k] for k in GRANITE_TRAIN_SMOKE_COUNTS}
    assert got == GRANITE_TRAIN_SMOKE_COUNTS
    assert res["memory_analysis"]["argument_size_in_bytes"] == 616452


def test_flops_are_linear_in_the_blocks(runs):
    """The JAX dry run's k1/k2 extrapolation (k1, k2 = 1, 2 at phi3's
    smoke depth of 2 blocks) gives the counted FLOPs exactly: at the full
    depth and at 3 blocks."""
    f = runs["blocks"]
    nb_full = dryrun._n_blocks_full(get_config("phi3-mini-3.8b", smoke=True))
    assert nb_full == 2 and specs.scale_config(
        get_config("phi3-mini-3.8b", smoke=True), 2) == get_config(
            "phi3-mini-3.8b", smoke=True)
    k1, k2 = 1, 2
    body = (f[k2] - f[k1]) / (k2 - k1)
    base = f[k1] - k1 * body
    assert body > 0 and base > 0
    assert runs["phi3-mini-3.8b", "train_4k"]["flops_per_dev"] == (
        base + nb_full * body)
    assert f[3] == base + 3 * body


def test_collective_bytes_of_known_redistributions():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                          distribute_tensor)
    with dryrun.fake_group(256):
        mesh = make_production_mesh(device_type="cpu")
        with FakeTensorMode():
            x = distribute_tensor(torch.empty(1024, 512), mesh,
                                  [Shard(0), Replicate()])
            # all-gather over data: each rank ends with the whole 2 MiB
            got = dryrun.collective_bytes(
                x.redistribute, mesh, [Replicate(), Replicate()])
            assert got == {"all-gather": 1024 * 512 * 4,
                           "total": 1024 * 512 * 4}
            p = DTensor.from_local(torch.empty(1024, 512), mesh,
                                   [Replicate(), Partial()], run_check=False)
            # reduce-scatter over model: each rank keeps 1/16 of the sum
            got = dryrun.collective_bytes(
                p.redistribute, mesh, [Replicate(), Shard(0)])
            assert got == {"reduce-scatter": 1024 * 512 * 4 // 16,
                           "total": 1024 * 512 * 4 // 16}
            # all-reduce over model: each rank keeps the whole sum
            got = dryrun.collective_bytes(
                p.redistribute, mesh, [Replicate(), Replicate()])
            assert got == {"all-reduce": 1024 * 512 * 4,
                           "total": 1024 * 512 * 4}
    assert not dist.is_initialized()


def test_refusals(tmp_path):
    with pytest.raises(ValueError, match="kernel"):
        dryrun.run_case("phi3-mini-3.8b", "train_4k", False, smoke=True,
                        outdir=str(tmp_path),
                        builder_kw={"attn_impl": "kernel"})
    assert not dist.is_initialized()
    with dryrun.fake_group(1):
        with pytest.raises(RuntimeError, match="256"):
            dryrun.run_case("phi3-mini-3.8b", "train_4k", False, smoke=True,
                            outdir=str(tmp_path))
        assert dist.get_world_size() == 1
    assert not dist.is_initialized()
    assert not list(tmp_path.iterdir())


def test_jsons_render_through_the_roofline(runs, capsys):
    """Each run's JSON is on disk under its JAX tag, and the port's
    roofline renders a row of it."""
    import json
    from repro_torch.launch import roofline
    d = pathlib.Path(runs["dir"])
    for arch, shape in CASES:
        on_disk = json.loads((d / f"{arch}_{shape}_16x16.json").read_text())
        assert on_disk == json.loads(json.dumps(runs[arch, shape]))
    roofline.main(["--dir", str(d)])
    rows = capsys.readouterr().out.splitlines()
    assert len(rows) == 2 + len(CASES)
    phi3 = sorted(CASES).index(("phi3-mini-3.8b", "train_4k"))
    assert "| phi3-mini-3.8b | train_4k |" in rows[2 + phi3]


def test_tree_loss_remat_backward_uses_the_given_weights():
    """The dry run's train step differentiates ``tree_loss`` with remat
    on over a meta skeleton: the backward's recomputation must read the
    tree it was given (it once read the module's own, meta, weights), so
    the gradients equal remat off's."""
    from repro_torch.core.trainer import value_and_grad
    from repro_torch.models import transformer as tfm
    cfg = dataclasses.replace(get_config("phi3-mini-3.8b", smoke=True),
                              dtype="float32")
    params = tfm.stacked_params(tfm.LM(cfg, device="cpu"))
    model = tfm.meta_lm(cfg)
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab, (2, 16), generator=gen)
    batch = {"tokens": tokens, "labels": tokens.roll(-1, 1)}
    got = {r: value_and_grad(lambda p: tfm.tree_loss(model, p, batch,
                                                     remat=r), params)
           for r in (False, True)}
    assert torch.equal(got[True][0], got[False][0])
    for path, g in tu.flatten_with_path(got[True][1]):
        want = dict(tu.flatten_with_path(got[False][1]))[path]
        torch.testing.assert_close(g, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", list(XLA_CASES))
def test_argument_bytes_equal_xla(runs, case):
    assert (runs["port"][case][1]
            == runs["xla"][case]["argument_size_in_bytes"])


@pytest.mark.parametrize("case", list(XLA_CASES))
def test_flops_per_device_near_xla(runs, case):
    matmuls, _, flops, _ = runs["port"][case]
    assert matmuls == runs["xla"][case]["dot_flops"]
    ratio = flops / runs["xla"][case]["flops"]
    lo, hi = FLOP_BANDS[case]
    assert lo <= ratio <= hi, ratio


@pytest.mark.parametrize("case", list(XLA_FINER))
def test_ten_heads_split_finer_than_xla(runs, case):
    """10 heads over a 16-wide ``model`` axis: XLA's dots a device are
    more than 7x the port's (7.8x: XLA splits the heads 2 ways, the port
    the query sequence 16 ways; the projections split alike), its
    temporaries larger, the arguments equal."""
    matmuls, args, _, temp = runs["port"][case]
    xla = runs["xla"][case]
    assert args == xla["argument_size_in_bytes"]
    assert 7 * matmuls < xla["dot_flops"]
    assert temp < xla["temp_size_in_bytes"]


@pytest.mark.parametrize("variants", [False, True])
def test_roofline_prints_what_jax_prints(runs, variants):
    from repro.launch import roofline as jax_roofline
    from repro_torch.launch import roofline
    argv = ["--dir", runs["dir"]] + (["--variants"] if variants else [])

    def printed(main):
        buf = io.StringIO()
        old = sys.argv
        sys.argv = ["roofline"] + argv
        try:
            with contextlib.redirect_stdout(buf):
                main()
        finally:
            sys.argv = old
        return buf.getvalue()

    want = printed(jax_roofline.main)
    assert printed(roofline.main) == want
    assert "| sage-dit | sage_serve |" in want


@torch.library.custom_op("dryrun_test::twice", mutates_args=())
def _twice(x: torch.Tensor) -> torch.Tensor:
    """An op DTensor has no strategy for."""
    return x * 2


@_twice.register_fake
def _(x):
    return torch.empty_like(x)


@pytest.mark.parametrize("sharded", [False, True])
def test_an_op_without_a_plan_is_refused_where_sharded(sharded):
    """An op with no DTensor plan at any placement runs whole on every
    rank: where its input was sharded, that is noted and refused (the
    count would be the torch version's op coverage, not the sharded
    step's); on a replicated input it is what every plan does."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    places = [Shard(0), Shard(1)] if sharded else [Replicate()] * 2
    with dryrun.fake_group(256):
        mesh = make_production_mesh(device_type="cpu")
        with FakeTensorMode(allow_non_fake_inputs=True), \
                specs.dtensor_rules() as fb:
            x = distribute_tensor(torch.zeros(256, 64), mesh, places)
            with dryrun.LocalCounter() as c:
                _twice(x)
    name = "dryrun_test.twice.default"
    assert fb.taken[name] >= 1
    assert "does not have a sharding strategy" in fb.why[name]
    if not sharded:
        assert not fb.whole and c.collectives() == {"total": 0}
        fb.refuse_whole()
        return
    assert fb.whole == {name: 1}
    # gathered over model (this data shard's 16 rows), then over data
    gathered = 16 * 64 * 4 + 256 * 64 * 4
    assert c.collectives() == {"all-gather": gathered, "total": gathered}
    with pytest.raises(RuntimeError, match="no plan for .*twice"):
        fb.refuse_whole()
    assert not dist.is_initialized()


def test_a_fault_in_a_strategy_is_raised(monkeypatch):
    """An error in one of ``specs``' own strategies is a fault of the dry
    run, not a missing plan: it is raised, and nothing falls back."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Shard, distribute_tensor

    def broken(op_schema):
        raise IndexError("a bug")
    monkeypatch.setattr(specs, "_flip_strategy", broken)
    with dryrun.fake_group(256):
        mesh = make_production_mesh(device_type="cpu")
        with FakeTensorMode(allow_non_fake_inputs=True), \
                specs.dtensor_rules() as fb:
            x = distribute_tensor(torch.zeros(256, 64), mesh,
                                  [Shard(0), Shard(1)])
            with pytest.raises(RuntimeError, match="broken on aten.flip"):
                torch.flip(x, (0,))
    assert not fb.taken and not fb.whole
    assert not dist.is_initialized()


def _strategy(spec):
    """A DTensor spec as the one-plan ``OpStrategy`` DTensor hands a
    strategy."""
    from torch.distributed.tensor._op_schema import OpSpec, OpStrategy
    return OpStrategy([OpSpec(spec)])


@pytest.mark.parametrize("form", ["strategy", "spec"])
def test_index_put_strategy_takes_both_index_list_forms(form):
    """A ring cache's write, ``cache[:, slots] = k`` (``index_put_`` with
    the index list ``[None, slots]``), keeps the cache's placement on
    every torch version: torch 2.13 hands the index tensor over as a
    strategy, 2.11 as a bare spec beside the strategies of ``self`` and
    the values (``form``).  Each tensor argument gets a spec, the index
    whole, the values sharded like the cache."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._dtensor_spec import DTensorSpec, TensorMeta
    from torch.distributed.tensor._op_schema import OpSchema
    from torch.distributed.tensor._sharding_prop import (
        _select_min_cost_strategy)
    with dryrun.fake_group(256):
        mesh = make_production_mesh(device_type="cpu")
        with FakeTensorMode():
            def spec(shape, placements, dtype=torch.bfloat16):
                t = torch.empty(shape, dtype=dtype)
                return DTensorSpec(mesh, tuple(placements), tensor_meta=(
                    TensorMeta(t.shape, t.stride(), t.dtype)))
            cache = spec((32, 64, 1, 128), [Shard(0), Shard(3)])
            slots = spec((64,), [Replicate()] * 2, torch.int64)
            values = spec((32, 64, 1, 128), [Shard(0), Shard(3)])
            index = _strategy(slots) if form == "strategy" else slots
            schema = OpSchema(torch.ops.aten.index_put_.default,
                              (_strategy(cache), [None, index],
                               _strategy(values)), {})
            plan = _select_min_cost_strategy(
                specs._index_put_strategy(schema), schema)
    assert [s.placements for s in plan.input_specs] == [
        (Shard(0), Shard(3)), (Replicate(), Replicate()),
        (Shard(0), Shard(3))]
    assert plan.output_spec.placements == (Shard(0), Shard(3))
    assert sum(sum(c) for c in plan.redistribute_cost) == 0
    assert not dist.is_initialized()


@pytest.mark.parametrize("heads", [(32, 8), (10, 1)])
def test_a_head_split_moves_onto_the_query_sequence(heads):
    """A view that splits heads sharded 16 ways: GQA's
    ``q.reshape(B, S, Hkv, g, hd)`` with 32 heads and 8 KV heads, which
    DTensor refuses, and recurrentgemma's 10 heads out of a projection
    sharded 16 ways, which DTensor places by gathering them.  Either way
    the ``model`` axis moves onto the query sequence instead (an
    all-to-all, no gather), the view keeps it there, and the move is
    noted as the view's fallback."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Shard, distribute_tensor
    B, S, hd = 32, 1024, 16
    H, Hkv = heads
    shape, new = (((B, S, H, hd), (B, S, Hkv, H // Hkv, hd)) if H % 16 == 0
                  else ((B, S, H * hd), (B, S, H, hd)))
    with dryrun.fake_group(256):
        mesh = make_production_mesh(device_type="cpu")
        with FakeTensorMode(allow_non_fake_inputs=True), \
                specs.dtensor_rules() as fb:
            q = distribute_tensor(torch.zeros(shape), mesh,
                                  [Shard(0), Shard(2)])
            with dryrun.LocalCounter() as c:
                out = q.reshape(new)
            placements = out.placements
            local = tuple(out.to_local().shape)
    moved = B // 16 * S // 16 * H * hd * 4
    assert placements == (Shard(0), Shard(1))
    assert local == (B // 16, S // 16) + new[2:]
    assert c.collectives() == {"all-to-all": moved, "total": moved}
    assert fb.taken == {"aten.view.default": 1} and not fb.whole
    assert not dist.is_initialized()


@pytest.mark.parametrize("op", ["rsqrt", "mul"])
def test_a_partial_input_to_a_pointwise_op_takes_one_plan(op):
    """A partial sum over ``model`` (a norm's mean of a row-parallel
    product) into a pointwise op: not linear in it (``rsqrt``), it is
    reduce-scattered onto a dim the op keeps, as DTensor 2.13 does (2.11
    all-reduced it, and the DiT then ran all heads on every ``model``
    rank); linear in it (``mul`` by a replicated tensor), it stays
    partial.  The plan is the module's own, the same on every torch
    version."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                          distribute_tensor)
    with dryrun.fake_group(256):
        mesh = make_production_mesh(device_type="cpu")
        with FakeTensorMode(allow_non_fake_inputs=True), \
                specs.dtensor_rules():
            prop = DTensor._op_dispatcher.sharding_propagator
            assert prop.op_strategy_funcs[torch.ops.aten.rsqrt.default] \
                .__wrapped__ is specs._pointwise_strategy
            x = DTensor.from_local(torch.empty(8, 1024, 1), mesh,
                                   [Shard(0), Partial()], run_check=False)
            s = distribute_tensor(torch.zeros(128, 1024, 1), mesh,
                                  [Shard(0), Replicate()])
            with dryrun.LocalCounter() as c:
                y = torch.rsqrt(x) if op == "rsqrt" else x * s
            placements = y.placements
    if op == "rsqrt":
        assert placements == (Shard(0), Shard(1))
        assert c.collectives() == {"reduce-scatter": 8 * 64 * 4,
                                   "total": 8 * 64 * 4}
    else:
        assert placements == (Shard(0), Partial())
        assert c.collectives() == {"total": 0}
    assert not dist.is_initialized()


def _t_rule_of_torch_2_11(op_schema):
    """DTensor 2.11's plan for ``aten.t``: a ``Shard``'s dim swapped, a
    ``_StridedShard`` kept on the dim it had."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.distributed.tensor._op_schema import OpSpec, OpStrategy
    out = []
    for s in op_schema.args_schema[0].strategies:
        spec = s.output_spec
        out.append(OpSpec(DTensorSpec(spec.mesh, tuple(
            Shard(1 - p.dim) if type(p) is Shard else p
            for p in spec.placements)), input_specs=(spec,)))
    return OpStrategy(out)


def test_a_strided_transpose_swaps_its_dim_on_every_torch(monkeypatch):
    """The chain on which granite-20b ``train_4k --smoke`` failed on torch
    2.11: an activation (256, 4096, 256) with its batch sharded over
    ``data`` and its sequence over ``model`` is flattened for a
    projection ((1048576, 256) at ``Shard(0)``, ``_StridedShard(0)``);
    the weight's gradient transposes it and multiplies it by the output's
    gradient.  With DTensor's own ``aten.t`` rule set to 2.11's, which
    kept the ``_StridedShard`` on dim 0 of the transpose, its local rows
    did not match and the ``mm`` raised; under ``dtensor_rules()`` the
    module's own rule swaps the strided dim as 2.13 does, on every torch
    version."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor
    from torch.distributed.tensor.placement_types import _StridedShard
    aten = torch.ops.aten
    prop = DTensor._op_dispatcher.sharding_propagator
    monkeypatch.setitem(prop.op_strategy_funcs, aten.t.default,
                        _t_rule_of_torch_2_11)
    B, S, D = 256, 4096, 256
    with dryrun.fake_group(256):
        mesh = make_production_mesh(device_type="cpu")
        with FakeTensorMode(allow_non_fake_inputs=True), \
                specs.dtensor_rules() as fb:
            x = distribute_tensor(torch.zeros(B, S, D, dtype=torch.bfloat16),
                                  mesh, [Shard(0), Shard(1)])
            dy = distribute_tensor(torch.zeros(B * S, D,
                                               dtype=torch.bfloat16),
                                   mesh, [Shard(0), Shard(1)])
            with dryrun.LocalCounter() as c:
                flat = x.view(B * S, D)
                xt = flat.t()
                grad_w = xt @ dy
            got = {name: (t.placements, tuple(t.to_local().shape))
                   for name, t in (("flat", flat), ("xt", xt),
                                   ("grad_w", grad_w))}
            own = prop.op_strategy_funcs[aten.t.default]
    strided = _StridedShard(0, split_factor=16)
    assert got["flat"] == ((Shard(0), strided), (B * S // 256, D))
    assert got["xt"] == ((Shard(1), _StridedShard(1, split_factor=16)),
                         (D, B * S // 256))
    assert grad_w.shape == (D, D)
    assert own.__wrapped__ is specs._t_strategy
    assert prop.op_strategy_funcs[aten.t.default] is _t_rule_of_torch_2_11
    assert not fb.whole and not dist.is_initialized()
    assert c.flops == GRANITE_GRAD_W_FLOPS, c.flops
    assert c.collectives() == GRANITE_GRAD_W_COLLECTIVES, c.collectives()


def test_chip_smoke_holds_each_dry_run_case_to_its_expected_counts():
    """``chip_smoke.py``'s ``dryrun`` phase holds every case of
    ``DRYRUN_CASES`` to ``DRYRUN_EXPECTED`` (FLOPs and collective bytes a
    device by kind, torch 2.13's): equal counts pass, and a difference in
    any kind fails the phase rather than printing a warning."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert set(chip_smoke.DRYRUN_EXPECTED) == set(chip_smoke.DRYRUN_CASES)
    assert {("recurrentgemma-2b", "prefill_32k", False),
            ("granite-20b", "prefill_32k", False),
            ("granite-20b", "train_4k", True)} <= set(
                chip_smoke.DRYRUN_CASES)
    # the smoke case's counts are the ones this module pins on the CPU
    assert chip_smoke.DRYRUN_EXPECTED["granite-20b", "train_4k", True] == (
        GRANITE_TRAIN_SMOKE_COUNTS)
    for case, want in chip_smoke.DRYRUN_EXPECTED.items():
        arch, shape, smoke = case
        assert want["collective_bytes_per_dev"]["total"] == sum(
            v for k, v in want["collective_bytes_per_dev"].items()
            if k != "total")
        failures = []
        chip_smoke._dryrun_expected(failures, case, dict(want))
        assert failures == []
        coll = dict(want["collective_bytes_per_dev"])
        coll["all-gather"] = coll.get("all-gather", 0) + 1
        chip_smoke._dryrun_expected(failures, case, dict(
            want, collective_bytes_per_dev=coll))
        assert len(failures) == 1 and f"{arch}:{shape}" in failures[0]


def test_roofline_compares_two_runs_case_by_case(runs, tmp_path, capsys):
    """``roofline --against``: a run against itself counts the same in
    every case; a case whose FLOPs or collective bytes of one kind differ,
    or that one run lacks, is printed."""
    from repro_torch.launch import roofline
    roofline.main(["--dir", runs["dir"], "--against", runs["dir"]])
    # the cases and the sage JSON tagged dp_only
    n = len(CASES) + 1
    assert capsys.readouterr().out.splitlines() == [
        "", f"{n} of {n} cases count the same"]
    other = tmp_path / "other"
    other.mkdir()
    for f in pathlib.Path(runs["dir"]).glob("*.json"):
        r = json.loads(f.read_text())
        if r["arch"] == "mamba2-780m":
            continue
        if r["arch"] == "phi3-mini-3.8b":
            r["collective_bytes_per_dev"]["all-gather"] += 1
        (other / f.name).write_text(json.dumps(r))
    roofline.main(["--dir", runs["dir"], "--against", str(other)])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "mamba2-780m:decode_32k:16x16:baseline: only in this run"
    assert out[1].startswith("phi3-mini-3.8b:train_4k:16x16:baseline: "
                             "collective_bytes_per_dev")
    assert out[-1] == f"{n - 2} of {n - 1} cases count the same"
