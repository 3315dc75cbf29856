"""The dry run's per-device argument bytes held to the JAX builders'
exactly, case for case: every assigned arch x the four shapes, plus
``sage-dit:sage_serve``, at full size, on the 16x16 and 2x16x16
production meshes, for the baseline and for the ``adafactor``,
``seqshard`` and ``dp_only`` variants on the cases they change (the
optimizer state of a train step, the cache of a decode step, the DiT's
replicated weights; elsewhere a variant's case is the baseline's).

The port's side is ``repro_torch.launch.specs.build_case`` on a fake
group of 256 or 512 ranks under ``FakeTensorMode``, summed over the
arguments' local shards.  JAX's side is ``repro.launch.specs.build_case``
on an ``AbstractMesh`` (no devices, no compile), summed over each
argument's shard shape, rounded up where a dim does not divide (as XLA
pads): what XLA's ``memory_analysis().argument_size_in_bytes`` reports
for these cases (``tests/test_torch_dryrun.py`` compiles five)."""
import math

import jax
import pytest
from jax.sharding import AbstractMesh
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.config import SHAPES as JAX_SHAPES
from repro.configs import ASSIGNED
from repro.launch import specs as jax_specs
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import make_production_mesh

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
CASES = ([(a, s) for a in ASSIGNED for s in JAX_SHAPES]
         + [("sage-dit", "sage_serve")])
#: the kind of case each variant changes
VARIANT_KINDS = {"": None, "adafactor": "train", "seqshard": "decode",
                 "dp_only": "sage"}


def _kind(shape):
    return "sage" if shape == "sage_serve" else JAX_SHAPES[shape].kind


PARAMS = [(v, a, s) for v, kind in VARIANT_KINDS.items() for a, s in CASES
          if kind is None or _kind(s) == kind]


def _jax_argument_bytes(case) -> int:
    total = 0
    for leaf in jax.tree.leaves(case.args):
        sh = leaf.sharding
        sizes = dict(zip(sh.mesh.axis_names, sh.mesh.axis_sizes))
        spec = tuple(sh.spec) + (None,) * (len(leaf.shape) - len(sh.spec))
        n = 1
        for dim, entry in zip(leaf.shape, spec):
            names = (() if entry is None else
                     entry if isinstance(entry, tuple) else (entry,))
            n *= -(-dim // math.prod(sizes[a] for a in names))
        total += n * leaf.dtype.itemsize
    return total


@pytest.fixture(scope="module", params=list(MESHES))
def meshes(request):
    """(the port's mesh on a fake group, JAX's abstract mesh); the group
    is destroyed after the module's cases on it."""
    shape, names = MESHES[request.param]
    with dryrun.fake_group(math.prod(shape)):
        yield (make_production_mesh(multi_pod=len(shape) == 3,
                                    device_type="cpu"),
               AbstractMesh(shape, names))


@pytest.mark.parametrize("variant,arch,shape", PARAMS)
def test_argument_bytes_equal_jax(meshes, variant, arch, shape):
    mesh, abstract = meshes
    kw = dryrun.VARIANTS.get(variant, {})
    want = _jax_argument_bytes(jax_specs.build_case(arch, shape, abstract,
                                                    **kw))
    with FakeTensorMode(allow_non_fake_inputs=True), specs.dtensor_rules():
        got = dryrun.local_bytes(specs.build_case(arch, shape, mesh,
                                                  **kw).args)
    assert got == want
