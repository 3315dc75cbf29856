"""The port's sharding rules (``repro_torch.sharding.partition``) held to
the JAX package's axis name for axis name, for every leaf of all ten
assigned configs at full size, on the 16x16 and 2x16x16 production
meshes: parameter specs with and without FSDP, AdamW's and adafactor's
state specs, and the decode cache specs at ``decode_32k`` and
``long_500k`` (4096-row rings for the non-SSM configs, as the JAX dry run
serves it) with and without ``seq_shard``; ``batch_axes``.  The shape
trees come from the meta device (``transformer.meta_lm``) and are held to
``jax.eval_shape``'s, path for path.  The rules read only axis sizes, so
a stand-in mesh serves, as in ``tests/test_sharding_and_variants.py``;
DTensor placements and the mesh constructors are checked on a
one-process gloo group."""
import time

import jax
import pytest
import torch
import torch.distributed as dist

from repro.config import OptimConfig as JaxOptimConfig
from repro.config import SHAPES as JAX_SHAPES
from repro.config import get_config as jax_get_config
from repro.configs import ASSIGNED
from repro.models import transformer as jax_tfm
from repro.optim.optimizers import make_optimizer as jax_make_optimizer
from repro.sharding import partition as jax_partition
from repro_torch import tree as tu
from repro_torch.config import SHAPES, OptimConfig, get_config
from repro_torch.launch import mesh as tmesh
from repro_torch.models import transformer as tfm
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.sharding import partition

#: the JAX dry run's long-context ring (``launch/specs.py``)
SERVE_WINDOW = 4096


class FakeMesh:
    """Duck-typed mesh: the rules read only ``.shape``."""

    def __init__(self, **axes):
        self.shape = axes


MESHES = {"16x16": FakeMesh(data=16, model=16),
          "2x16x16": FakeMesh(pod=2, data=16, model=16)}


def _jax_flat(tree, leaf=lambda x: x.shape):
    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa
    return [(jax.tree_util.keystr(k), leaf(v)) for k, v in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_spec)[0]]


def _flat(tree, leaf=lambda x: tuple(x.shape)):
    return [(tu.keystr(k), leaf(v)) for k, v in tu.flatten_with_path(tree)]


def _specs_equal(got, want):
    g = _flat(got, tuple)
    w = _jax_flat(want, tuple)
    assert [k for k, _ in g] == [k for k, _ in w]
    bad = [(k, a, b) for (k, a), (_, b) in zip(g, w) if a != b]
    assert not bad, bad[:5]


def _window(cfg, seq):
    return SERVE_WINDOW if (seq > 65536 and cfg.family != "ssm") else 0


@pytest.fixture(scope="module", params=ASSIGNED)
def trees(request):
    """The full config's parameter, optimizer and cache shape trees, JAX's
    (``eval_shape``) and the port's (the meta device)."""
    arch = request.param
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    t0 = time.perf_counter()
    model = tfm.meta_lm(cfg)
    params = tfm.stacked_params(model)
    port_s = time.perf_counter() - t0
    jparams = jax.eval_shape(
        lambda: jax_tfm.init_params(jcfg, jax.random.PRNGKey(0)))
    out = dict(arch=arch, jcfg=jcfg, cfg=cfg, params=params,
               jparams=jparams, port_s=port_s, opt={}, cache={})
    for kind in ("adamw", "adafactor"):
        out["opt"][kind] = (
            make_optimizer(OptimConfig(kind=kind)).init(params),
            jax.eval_shape(jax_make_optimizer(JaxOptimConfig(kind=kind)).init,
                           jparams))
    for name in ("decode_32k", "long_500k"):
        sh = SHAPES[name]
        B, S = sh.global_batch, sh.seq_len
        w = _window(cfg, S)
        out["cache"][name] = (tfm.init_cache(model, B, S, window=w),
                              jax.eval_shape(lambda: jax_tfm.init_cache(
                                  jcfg, B, S, window=w)))
    return out


def test_meta_shape_trees_equal_eval_shape(trees):
    assert _flat(trees["params"]) == _jax_flat(trees["jparams"])
    assert all(x.device.type == "meta" for x in tu.leaves(trees["params"]))
    # ~0.45 s at most alone (kimi-k2); drawing kimi's experts one by one
    # took 47 s, which a loaded CPU cannot hide under this bar
    assert trees["port_s"] < 20.0
    for kind, (got, want) in trees["opt"].items():
        assert _flat(got) == _jax_flat(want), kind
    for name, (got, want) in trees["cache"].items():
        assert _flat(got) == _jax_flat(want), name


@pytest.mark.parametrize("mesh", MESHES)
def test_param_specs_equal_jax(trees, mesh):
    m = MESHES[mesh]
    for fsdp in (False, True):
        _specs_equal(
            partition.param_specs(trees["cfg"], trees["params"], m, fsdp),
            jax_partition.param_specs(trees["jcfg"], trees["jparams"], m,
                                      fsdp))


@pytest.mark.parametrize("mesh", MESHES)
def test_opt_specs_equal_jax(trees, mesh):
    m = MESHES[mesh]
    for fsdp in (False, True):
        ps = partition.param_specs(trees["cfg"], trees["params"], m, fsdp)
        jps = jax_partition.param_specs(trees["jcfg"], trees["jparams"], m,
                                        fsdp)
        for kind, (got, want) in trees["opt"].items():
            _specs_equal(partition.opt_specs(ps, got),
                         jax_partition.opt_specs(jps, want))


@pytest.mark.parametrize("mesh", MESHES)
def test_cache_specs_equal_jax(trees, mesh):
    m = MESHES[mesh]
    for name, (got, want) in trees["cache"].items():
        B = SHAPES[name].global_batch
        for seq_shard in (False, True):
            _specs_equal(
                partition.cache_specs(trees["cfg"], got, m, B, seq_shard),
                jax_partition.cache_specs(trees["jcfg"], want, m, B,
                                          seq_shard))


def test_shapes_are_jaxs():
    assert SHAPES.keys() == JAX_SHAPES.keys()
    for k, v in SHAPES.items():
        w = JAX_SHAPES[k]
        assert (v.name, v.seq_len, v.global_batch, v.kind) == (
            w.name, w.seq_len, w.global_batch, w.kind)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("batch", [1, 2, 4, 16, 32, 64, 128, 256, 512, 3])
def test_batch_axes_equal_jax(mesh, batch):
    m = MESHES[mesh]
    assert partition.batch_axes(m, batch) == jax_partition.batch_axes(
        m, batch)


def test_spec_normalises_one_name_tuples_as_jax():
    P, JP = partition.P, jax.sharding.PartitionSpec
    for axes in [(), (None,), (("data",), None), (("pod", "data"), "model")]:
        assert tuple(P(*axes)) == tuple(JP(*axes))
    assert P("model", None) == ("model", None) == P("model", None)


@pytest.fixture
def one_process_group(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    yield
    dist.destroy_process_group()


def test_mesh_constructors_need_a_matching_world(one_process_group):
    with pytest.raises(RuntimeError, match="256 processes"):
        tmesh.make_production_mesh(device_type="cpu")
    with pytest.raises(RuntimeError, match="512 processes"):
        tmesh.make_production_mesh(multi_pod=True, device_type="cpu")
    with pytest.raises(RuntimeError, match="8 processes"):
        tmesh.make_debug_mesh(device_type="cpu")
    mesh = tmesh.make_debug_mesh(1, 1, device_type="cpu")
    assert partition.axis_sizes(mesh) == {"data": 1, "model": 1}


def test_shard_tree_places_tensors_by_spec(one_process_group):
    mesh = tmesh.make_debug_mesh(1, 1, device_type="cpu")
    from torch.distributed.tensor import Replicate, Shard
    P = partition.P
    assert partition.placements(P(None, "model"), mesh) == [Replicate(),
                                                           Shard(1)]
    assert partition.placements(P(("data", "model"), None), mesh) == [
        Shard(0), Shard(0)]
    tree = {"w": torch.randn(4, 8), "b": [torch.randn(8)]}
    specs = {"w": P("data", "model"), "b": [P(None)]}
    out = partition.shard_tree(tree, specs, mesh)
    assert tuple(out["w"].placements) == (Shard(0), Shard(1))
    assert tuple(out["b"][0].placements) == (Replicate(), Replicate())
    assert torch.equal(out["w"].full_tensor(), tree["w"])


def test_rules_fail_without_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="none initialised"):
        tmesh.make_debug_mesh(1, 1, device_type="cpu")
