"""The expert-parallel all-to-all MoE on the port (`nn/moe_a2a.py`)
against the reference's `moe_ffn_a2a`.

The reference runs under `shard_map` on a (2, 4) ("data", "model") mesh
of 8 forced host devices, in one subprocess for the whole file (the
main process keeps its own device view), which writes its weights,
inputs, outputs and gradients to an `.npz`; the port runs the same
arrays on a co-located (2, 4) CPU mesh.

- capacity_factor 8.0 (no token dropped) and 1.25, where the per-block
  capacity drops tokens that the dense dispatch's global one keeps:
  output rtol / atol 2e-4 and gradients rtol 5e-3, atol 5e-4
  (`tests/test_moe_a2a.py`'s tolerances), each against the reference's
  a2a, not the dense path;
- the decode shape (s = 1, seq unsharded: every model rank holds the
  same tokens);
- the dispatcher takes the a2a path on a model axis above 1 and the
  dense one on a 1-wide model axis.
"""
import _torch_cpu  # noqa: F401  (this worker's share of the cores)
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.distributed.sharding import Constrainer
from repro_torch.launch.mesh import make_mesh
from repro_torch.nn import moe as TM
from repro_torch.nn import moe_a2a as TA
from repro_torch.nn.config import ModelConfig

OUT_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=5e-3, atol=5e-4)
CFG = dict(name="t", family="moe", num_layers=2, d_model=32, n_heads=4,
           n_kv_heads=2, d_ff=64, vocab_size=128, n_experts=8, top_k=2)
RULES = {"batch": ("data",), "seq": "model", "experts": "model",
         "embed": "data", "mlp": "model"}
CASES = {"train_cf8": ((8, 16, 32), 8.0), "train_cf125": ((8, 16, 32), 1.25),
         "decode": ((8, 1, 32), 1.25), "shared_cf125": ((4, 8, 32), 1.25)}

_SUBPROC = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.nn.config import ModelConfig
    from repro.nn.moe import moe_ffn_dense, moe_specs
    from repro.nn.moe_a2a import moe_ffn_a2a
    from repro.nn.param import ParamSpec

    cfg_kw, rules, cases, out = eval(sys.argv[1]), eval(sys.argv[2]), \\
        eval(sys.argv[3]), sys.argv[4]
    from repro.nn.layers import mlp, no_sc
    mesh = jax.make_mesh((2, 4), ("data", "model"))
    arrays = {}
    for name, (shape, cf) in cases.items():
        kw = dict(cfg_kw)
        if name.startswith("shared"):
            kw["n_shared_experts"] = 1
        cfg = ModelConfig(**kw)
        rng = np.random.default_rng(abs(hash(name)) % 1000)
        p = jax.tree.map(
            lambda s: (rng.standard_normal(s.shape) * 0.3).astype(np.float32),
            moe_specs(cfg), is_leaf=lambda x: isinstance(x, ParamSpec))
        x = rng.standard_normal(shape).astype(np.float32)
        jp = jax.tree.map(jnp.asarray, p)
        jx = jnp.asarray(x)
        routed = {k: v for k, v in jp.items() if k != "shared"}
        # the shared experts are added after the combine, outside the
        # shard_map (moe_a2a.py:146-150); run under the mesh that add
        # trips jax 0.9's sharding-typed reshape, so it runs here without
        # the mesh, on the same formula
        cfg0 = ModelConfig(**cfg_kw)
        f = jax.jit(lambda p, x: moe_ffn_a2a(cfg0, p, x, mesh, rules,
                                             capacity_factor=cf))
        sh = lambda ps, x: mlp(ps, x.reshape(-1, x.shape[-1]), no_sc
                               ).reshape(x.shape)
        with mesh:
            y_r, vjp_r = jax.vjp(f, routed, jx)
        y = np.asarray(y_r)
        if "shared" in jp:
            y_s, vjp_s = jax.vjp(sh, jp["shared"], jx)
            y = y + np.asarray(y_s)
        arrays[f"{name}/x"] = x
        arrays[f"{name}/y"] = y
        arrays[f"{name}/dense"] = np.asarray(
            moe_ffn_dense(cfg, jp, jx, capacity_factor=cf))
        for k, v in jax.tree_util.tree_flatten_with_path(p)[0]:
            arrays[f"{name}/p/" + "/".join(e.key for e in k)] = v
        if shape[1] > 1:
            cot = jnp.asarray(2.0 * y)    # d sum(y ** 2) / dy
            with mesh:
                g, gx = vjp_r(cot)
            g, gx = dict(g), np.asarray(gx)
            if "shared" in jp:
                g["shared"], gx_s = vjp_s(cot)
                gx = gx + np.asarray(gx_s)
            for k, v in jax.tree_util.tree_flatten_with_path(g)[0]:
                arrays[f"{name}/g/" + "/".join(e.key for e in k)] = (
                    np.asarray(v))
            arrays[f"{name}/gx"] = np.asarray(gx)
    np.savez(out, **arrays)
    print("REF_OK")
""")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("a2a") / "ref.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = "src"
    r = subprocess.run([sys.executable, "-c", _SUBPROC, repr(CFG),
                        repr(RULES), repr(CASES), str(out)], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0 and "REF_OK" in r.stdout, (
        r.stdout[-3000:] + r.stderr[-3000:])
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def _case(ref, name):
    kw = dict(CFG)
    if name.startswith("shared"):
        kw["n_shared_experts"] = 1
    cfg = ModelConfig(**kw)
    p = {}
    for key, v in ref.items():
        if key.startswith(f"{name}/p/"):
            node = p
            *path, leaf = key[len(f"{name}/p/"):].split("/")
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = torch.from_numpy(v)
    return cfg, p, torch.from_numpy(ref[f"{name}/x"]), CASES[name][1]


def _mesh(shape=(2, 4)):
    return make_mesh(shape, ("data", "model"), device="cpu")


@pytest.mark.parametrize("name", list(CASES))
def test_a2a_output_equals_the_reference(ref, name):
    cfg, p, x, cf = _case(ref, name)
    got = TA.moe_ffn_a2a(cfg, p, x, _mesh(), RULES, capacity_factor=cf)
    np.testing.assert_allclose(got.numpy(), ref[f"{name}/y"], **OUT_TOL)
    dense = ref[f"{name}/dense"]
    if name == "train_cf8":
        # no token dropped: the a2a is the dense dispatch
        np.testing.assert_allclose(got.numpy(), dense, **OUT_TOL)
    if name == "train_cf125":
        # the per-block capacity drops tokens the global one keeps
        assert not np.allclose(ref[f"{name}/y"], dense, **OUT_TOL)


@pytest.mark.parametrize("name", [n for n, (s, _) in CASES.items()
                                  if s[1] > 1])
def test_a2a_gradients_equal_the_reference(ref, name):
    cfg, p, x, cf = _case(ref, name)
    leaves = {k: v.clone().requires_grad_(True) for k, v in
              _flat(p).items()}
    xg = x.clone().requires_grad_(True)
    y = TA.moe_ffn_a2a(cfg, _unflat(leaves), xg, _mesh(), RULES,
                       capacity_factor=cf)
    torch.sum(y ** 2).backward()
    np.testing.assert_allclose(xg.grad.numpy(), ref[f"{name}/gx"],
                               **GRAD_TOL)
    for k, v in leaves.items():
        np.testing.assert_allclose(v.grad.numpy(), ref[f"{name}/g/{k}"],
                                   err_msg=k, **GRAD_TOL)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _unflat(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v
    return tree


def test_a2a_blocks_follow_the_divisibility_fallback(ref):
    """A batch the data axis does not divide and a sequence the model
    axis does not divide run unsharded along those dims: one block per
    model rank, every rank the same tokens, capacity from the whole
    batch — the dense dispatch at the same capacity."""
    cfg, p, _, _ = _case(ref, "train_cf8")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (3, 5, 32)).astype(np.float32))
    got = TA.moe_ffn_a2a(cfg, p, x, _mesh(), RULES, capacity_factor=1.25)
    want = TM.moe_ffn_dense(cfg, p, x, capacity_factor=1.25)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_dispatcher_takes_a2a_above_one_and_dense_at_one(ref, monkeypatch):
    cfg, p, x, _ = _case(ref, "train_cf125")
    calls = []
    real = TA.moe_ffn_a2a

    def spy(*a, **kw):
        calls.append(kw.get("capacity_factor"))
        return real(*a, **kw)

    monkeypatch.setattr(TA, "moe_ffn_a2a", spy)
    sc = Constrainer(_mesh(), RULES)
    got = TM.moe_ffn(cfg, p, x, sc)
    assert calls == [1.25]
    np.testing.assert_allclose(got.numpy(), ref["train_cf125/y"], **OUT_TOL)
    for shape in ((2, 1), (1, 1)):
        one = Constrainer(_mesh(shape))
        assert TA.model_axis_size(one.mesh, one.rules) == 1
        np.testing.assert_array_equal(
            TM.moe_ffn(cfg, p, x, one).numpy(),
            TM.moe_ffn_dense(cfg, p, x).numpy())
    assert calls == [1.25]
    assert TA.model_axis_size(sc.mesh, sc.rules) == 4
