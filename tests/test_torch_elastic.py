"""Elastic restore, meshes and sharding specs on the port
(`repro_torch.checkpoint.elastic`, `launch/mesh.py`, `distributed/
sharding.py`, `launch/specs.py`, `nn/param.py`) against the reference:
the five elastic and mesh tests of `tests/test_checkpoint_fault.py`, and
the `spec_to_pspec` / `batch_pspec` / `make_rules` / `param_pspecs` /
`train_batch_specs` / elastic-mesh cases of `tests/test_sharding_specs.py`,
every spec tree, mesh shape and microbatch split exactly the
reference's.  A port mesh co-locates its shards on one device (here the
CPU), so placement moves a tensor whole there."""
import _torch_cpu  # noqa: F401  (this worker's share of the cores)
import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.checkpoint import elastic as j_elastic
from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.configs import get_smoke as j_get_smoke
from repro.distributed import sharding as j_sharding
from repro.launch import mesh as j_mesh
from repro.launch import specs as j_specs
from repro.nn import param as j_param
from repro.nn import transformer as JT
from repro_torch.checkpoint.elastic import (adjust_microbatching,
                                            elastic_restore)
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.distributed.sharding import (Constrainer, NamedSharding, P,
                                              PartitionSpec, batch_pspec,
                                              make_rules, mesh_shape_dict,
                                              param_pspecs, param_shardings)
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import (make_elastic_mesh, make_mesh,
                                     make_production_mesh,
                                     single_device_mesh)
from repro_torch.nn import transformer as T
from repro_torch.nn.param import ParamSpec, map_tree, spec_to_pspec
from repro_torch.training.optimizer import tree_leaves, tree_map

CPU = "cpu"


def _tuples(tree, is_leaf):
    """A spec tree with every PartitionSpec as a plain tuple."""
    if is_leaf(tree):
        return tuple(tree)
    if isinstance(tree, dict):
        return {k: _tuples(v, is_leaf) for k, v in tree.items()}
    raise TypeError(type(tree))


def _port_tuples(tree):
    return _tuples(tree, lambda x: isinstance(x, PartitionSpec))


def _ref_tuples(tree):
    return _tuples(tree, lambda x: isinstance(x, JP))


class _FakeMesh:
    """Duck-typed reference mesh: its spec builders read only
    `axis_names` and `devices.shape`."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.zeros(shape)


# --------------------------------------------------------------- elastic
def _adam_tree(seed=0):
    rng = np.random.default_rng(seed)
    params = {"w": torch.from_numpy(rng.standard_normal((4, 4)).astype(
                  np.float32)),
              "b": torch.from_numpy(rng.standard_normal(4).astype(
                  np.float32))}
    return {"params": params,
            "opt": {"m": tree_map(torch.zeros_like, params),
                    "v": tree_map(torch.ones_like, params),
                    "count": torch.tensor(3, dtype=torch.int32)}}


def test_elastic_restore_places_params_and_opt(tmp_path):
    tree = _adam_tree()
    mgr = CheckpointManager(tmp_path)
    mgr.save(3, tree, metadata={"cursor": 9})
    mesh = make_elastic_mesh(1, 1, device=CPU)
    sh = map_tree(lambda _: NamedSharding(mesh, P()), tree["params"])
    like = tree_map(lambda t: torch.zeros_like(t), tree)
    got_mesh, placed, meta, step = elastic_restore(
        None, mgr, like, n_devices=1, model_parallel=1, shardings=sh,
        device=CPU)
    assert step == 3 and meta["cursor"] == 9
    assert got_mesh.shape == {"data": 1, "model": 1}
    # params AND the params-shaped moments are placed on the mesh
    for leaf in (tree_leaves(placed["params"])
                 + tree_leaves(placed["opt"]["m"])
                 + tree_leaves(placed["opt"]["v"])):
        assert isinstance(leaf, torch.Tensor)
        assert leaf.device == mesh.device
    assert int(placed["opt"]["count"]) == 3
    np.testing.assert_allclose(placed["opt"]["v"]["b"].numpy(), np.ones(4))
    np.testing.assert_array_equal(placed["params"]["w"].numpy(),
                                  tree["params"]["w"].numpy())


def test_elastic_restore_derives_shardings_from_the_config(tmp_path):
    """Without `shardings` the placement comes from `param_shardings(cfg,
    mesh)`: a SMOKE model's parameters and moments restored and placed,
    its step count kept."""
    from repro_torch.training.optimizer import init_opt_state
    cfg = get_smoke("granite_3_2b")
    params = T.init_params(cfg, seed=0, device=CPU)
    opt = init_opt_state(params)
    opt["count"] = torch.tensor(5, dtype=torch.int32)
    mgr = CheckpointManager(tmp_path)
    mgr.save(5, {"params": params, "opt": opt}, metadata={"cursor": 5})
    like = tree_map(torch.zeros_like, {"params": params, "opt": opt})
    mesh, placed, meta, step = elastic_restore(cfg, mgr, like, n_devices=4,
                                               model_parallel=2, device=CPU)
    assert mesh.shape == {"data": 2, "model": 2} and step == 5
    assert int(placed["opt"]["count"]) == 5 and meta["cursor"] == 5
    for a, b in zip(tree_leaves(placed["params"]), tree_leaves(params)):
        assert torch.equal(a, b)


def test_elastic_restore_placement_failure_warns(tmp_path):
    tree = _adam_tree()
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, tree)
    bad = map_tree(lambda _: "not-a-sharding", tree["params"])
    with pytest.warns(RuntimeWarning, match="placement"):
        _, placed, _, step = elastic_restore(
            None, mgr, tree, n_devices=1, shardings=bad, device=CPU)
    assert step == 1
    # loud fallback: the restored arrays, values intact
    np.testing.assert_array_equal(placed["params"]["w"].numpy(),
                                  tree["params"]["w"].numpy())


def test_elastic_restore_placement_failure_raises(tmp_path):
    tree = _adam_tree()
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, tree)
    bad = map_tree(lambda _: "not-a-sharding", tree["params"])
    with pytest.raises(TypeError, match="not a sharding"):
        elastic_restore(None, mgr, tree, n_devices=1, shardings=bad,
                        on_placement_error="raise", device=CPU)
    with pytest.raises(ValueError, match="on_placement_error"):
        elastic_restore(None, mgr, tree, on_placement_error="ignore",
                        device=CPU)


def test_adjust_microbatching_preserves_global_batch():
    for n_shards in (16, 12, 10, 7):
        per, micro = adjust_microbatching(256, n_shards)
        assert per * micro * n_shards <= 256
        if 256 % n_shards == 0:
            assert per * micro * n_shards == 256


@pytest.mark.parametrize("global_batch", [1, 7, 64, 256, 384])
def test_adjust_microbatching_equals_the_reference(global_batch):
    for n_shards in (1, 2, 3, 5, 7, 10, 12, 16, 300):
        for prev in (1, 2, 3):
            assert adjust_microbatching(global_batch, n_shards, prev) == \
                j_elastic.adjust_microbatching(global_batch, n_shards, prev)


def test_make_elastic_mesh_shrinks_model_axis():
    mesh = make_elastic_mesh(n_devices=1, model_parallel=16, device=CPU)
    assert mesh.devices.size == 1


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6, 7, 8])
def test_elastic_mesh_shape_equals_the_reference(n):
    """The reference's shrink rule, for every device count the suite's
    8-device view lets the reference build, and the visible-device
    default (1 on the CPU)."""
    for mp in (16, 8, 6, 4, 3, 1):
        ref = j_mesh.make_elastic_mesh(n, mp)
        ours = make_elastic_mesh(n, mp, device=CPU)
        assert ours.axis_names == tuple(ref.axis_names)
        assert ours.devices.shape == ref.devices.shape
        assert ours.device == torch.device(CPU)
    assert make_elastic_mesh(device=CPU).shape == {"data": 1, "model": 1}


def test_elastic_mesh_always_valid():
    for n in (1, 2, 3, 6, 16, 24, 100):
        m = make_elastic_mesh(n, device=CPU)
        d, mp = m.axis_sizes
        assert d * mp == n and mp <= 16 and n % mp == 0


def test_production_and_single_device_meshes():
    assert single_device_mesh(CPU).shape == {"data": 1, "model": 1}
    assert make_production_mesh(device=CPU).shape == {"data": 16,
                                                      "model": 16}
    pod = make_production_mesh(multi_pod=True, device=CPU)
    assert pod.axis_names == ("pod", "data", "model") and pod.size == 512
    with pytest.raises(ValueError, match="mesh shape"):
        make_mesh((2, 2), ("data",), device=CPU)


# --------------------------------------------------------------- specs
def test_spec_to_pspec_divisibility_fallback():
    ms = {"data": 16, "model": 16}
    s = ParamSpec((256, 64), ("embed", "mlp"))
    assert spec_to_pspec(s, ms) == P("data", "model")
    s2 = ParamSpec((100, 64), ("embed", "mlp"))
    assert spec_to_pspec(s2, ms) == P(None, "model")
    s3 = ParamSpec((256,), (None,))
    assert spec_to_pspec(s3, ms) == P(None)
    for shape, axes in (((256, 64), ("embed", "mlp")),
                        ((100, 64), ("embed", "mlp")),
                        ((256,), (None,)), ((8, 48), ("experts", "heads"))):
        assert tuple(spec_to_pspec(ParamSpec(shape, axes), ms)) == tuple(
            j_param.spec_to_pspec(j_param.ParamSpec(shape, axes), ms))


def test_batch_pspec_shape_fallback():
    """batch=1 must not shard over data=16 (the long_500k regression),
    as the reference's."""
    mesh = _FakeMesh((16, 16), ("data", "model"))
    rules = {"batch": "data", "seq": "model"}
    assert batch_pspec(mesh, 2, rules=rules, shape=(1, 1)) == P(None, None)
    sp = batch_pspec(mesh, 2, seq_axis=1, rules=rules, shape=(128, 32768))
    assert sp == P("data", "model")
    sp2 = batch_pspec(mesh, 2, seq_axis=1, rules=rules, shape=(128, 100))
    assert sp2 == P("data", None)
    for kw in (dict(shape=(1, 1)), dict(seq_axis=1, shape=(128, 32768)),
               dict(seq_axis=1, shape=(128, 100)), dict(seq_axis=1),
               dict()):
        assert tuple(batch_pspec(mesh, 2, rules=rules, **kw)) == tuple(
            j_sharding.batch_pspec(mesh, 2, rules=rules, **kw))


def test_constrainer_replicates_non_dividing():
    """The spec is the per-dimension fallback (stated here: the
    reference's own constrainer test cannot run under this jax), and
    the tensor passes unchanged."""
    sc = Constrainer(make_mesh((2, 4), ("data", "model"), device=CPU))
    x = torch.zeros((3, 8))
    assert sc.spec(x.shape, ("batch", "seq")) == P(None, "model")
    assert sc.spec((4, 6), ("batch", "seq")) == P("data", None)
    assert sc.spec((4, 8), (None, "mlp")) == P(None, "model")
    assert sc(x, ("batch", "seq")) is x
    one = Constrainer(single_device_mesh(CPU))
    assert tuple(one.spec((3, 5), ("batch", "seq"))) == ("data", "model")


def test_make_rules_drops_missing_axes():
    mesh = single_device_mesh(CPU)           # axes: data, model
    rules = make_rules(mesh)
    assert rules["batch"] == ("data",)    # "pod" dropped
    assert rules["embed"] == "data"
    assert make_rules(mesh, seq_sharded=False)["seq"] is None
    for shape, names in (((1, 1), ("data", "model")),
                         ((2, 16, 16), ("pod", "data", "model")),
                         ((4,), ("ring",))):
        fake = _FakeMesh(shape, names)
        for seq in (True, False):
            assert make_rules(fake, seq) == j_sharding.make_rules(fake, seq)
    assert mesh_shape_dict(make_production_mesh(device=CPU)) == {
        "data": 16, "model": 16}


@pytest.mark.parametrize("arch", ["granite_3_2b", "jamba_1_5_large_398b",
                                  "seamless_m4t_large_v2"])
def test_param_pspecs_tree_matches_params(arch):
    cfg = get_smoke(arch)
    ps = param_pspecs(cfg, single_device_mesh(CPU))
    ab = T.abstract_params(cfg)
    assert map_tree(lambda _: 0, ps,
                    is_leaf=lambda x: isinstance(x, PartitionSpec)) == \
        map_tree(lambda _: 0, ab)
    assert all(t.device.type == "meta" for t in tree_leaves(ab))
    sh = param_shardings(cfg, single_device_mesh(CPU))
    assert all(isinstance(s, NamedSharding) for s in tree_leaves(sh))


@pytest.mark.parametrize("arch", J_ARCH_IDS)
@pytest.mark.parametrize("shape", [(1, 1), (16, 16), (2, 4), (2, 16, 16)])
def test_param_pspecs_equal_the_reference(arch, shape):
    """Every full config's PartitionSpec tree, tuple for tuple, on the
    single-device, production, a small and the multi-pod mesh shape."""
    names = (("pod", "data", "model") if len(shape) == 3
             else ("data", "model"))
    fake = _FakeMesh(shape, names)
    ours = param_pspecs(get_config(arch), fake)
    ref = j_sharding.param_pspecs(j_get_config(arch), fake)
    assert _port_tuples(ours) == _ref_tuples(ref)


def test_train_batch_specs_shapes():
    cfg = get_config("granite_3_2b")
    b = SP.train_batch_specs(cfg, 4096, 256)
    assert b["tokens"].shape == (256, 4096)
    assert b["labels"].dtype == torch.int32
    assert b["tokens"].device.type == "meta"

    vlm = get_config("llama_3_2_vision_11b")
    bv = SP.train_batch_specs(vlm, 128, 4)
    assert "image_embeds" in bv["extras"]
    assert bv["extras"]["image_embeds"].shape[0] == 4

    ed = get_config("seamless_m4t_large_v2")
    be = SP.train_batch_specs(ed, 128, 4)
    assert be["extras"]["frames"].shape == (4, 128, ed.d_model)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_batch_specs_and_pspecs_equal_the_reference(arch):
    ours = SP.train_batch_specs(get_config(arch), 64, 8)
    ref = j_specs.train_batch_specs(j_get_config(arch), 64, 8)
    shapes = lambda t: {k: (shapes(v) if isinstance(v, dict)
                            else tuple(v.shape)) for k, v in t.items()}
    assert shapes(ours) == shapes(ref)
    for shape in ((1, 1), (16, 16)):
        fake = _FakeMesh(shape, ("data", "model"))
        assert _port_tuples(SP.train_batch_pspecs(get_config(arch), fake)) \
            == _ref_tuples(j_specs.train_batch_pspecs(j_get_config(arch),
                                                      fake))


def test_abstract_params_shapes_equal_the_reference():
    for arch in ("granite_3_2b", "jamba_1_5_large_398b",
                 "llama_3_2_vision_11b"):
        ours = map_tree(lambda t: tuple(t.shape),
                        T.abstract_params(get_smoke(arch)))
        ref = jax.tree.map(lambda s: tuple(s.shape),
                           JT.abstract_params(j_get_smoke(arch)))
        assert ours == ref
