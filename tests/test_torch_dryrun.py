"""The dry run and its cost accounting on the port (`launch/analysis.py`,
`launch/op_cost.py`, `launch/dryrun.py`, `nn/scan.py`'s loop scaling)
against the reference (`launch/analysis.py`, `launch/jaxpr_cost.py`,
`launch/dryrun.py`).

- `model_flops_estimate` equals the reference's for every arch and
  shape.
- The counter's matrix-product FLOPs equal the reference walker's
  `dot_general` FLOPs (`jaxpr_cost_breakdown`) on SMOKE granite and
  moonshot prefill and decode (rtol 1e-6) and train step (1%; they are
  equal there too), and on the other families' train steps within 1%:
  there the gap is the Mamba blocks' nested remat, whose time loop
  `torch.utils.checkpoint` recomputes once more inside the period's
  recomputation than the reference's nested `jax.checkpoint` does
  (falcon-mamba 0.7%, jamba 0.3%).
- The twins of `tests/test_system.py`'s roofline, matmul and
  scan-multiplies tests.
- Loop scaling: the scaled count equals the unscaled one, FLOPs and
  bytes, op for op, at SMOKE widths with every loop above 3 trips.
- `run_cell` gives status ok or skipped for every (arch x shape) on the
  single mesh, as `shape_applicable` decides, with the reference's
  record fields.
"""
import _torch_cpu  # noqa: F401  (this worker's share of the cores)
import dataclasses
import json

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import get_smoke as j_get_smoke
from repro.launch import analysis as j_analysis
from repro.launch import specs as j_specs
from repro.launch.jaxpr_cost import jaxpr_cost_breakdown
from repro.nn import transformer as JT
from repro.training.optimizer import init_opt_state as j_init_opt_state
from repro.training.train_lib import make_train_step as j_make_train_step
from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.launch import analysis as A
from repro_torch.launch import dryrun as D
from repro_torch.launch import specs as SP
from repro_torch.launch.op_cost import (matmul_flops, traced_cost,
                                        traced_cost_breakdown)
from repro_torch.nn import transformer as T
from repro_torch.nn.scan import scan
from repro_torch.training.optimizer import init_opt_state
from repro_torch.training.train_lib import make_train_step

B, S = 2, 32
FAMILIES = ["granite_3_2b", "moonshot_v1_16b_a3b", "falcon_mamba_7b",
            "jamba_1_5_large_398b", "llama_3_2_vision_11b",
            "seamless_m4t_large_v2"]


# ------------------------------------------------------------ analysis
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_estimate_equals_the_reference(arch):
    for shape, info in SP.SHAPES.items():
        got = A.model_flops_estimate(get_config(arch), info["kind"],
                                     info["seq"], info["batch"])
        want = j_analysis.model_flops_estimate(
            j_get_config(arch), info["kind"], info["seq"], info["batch"])
        assert got == want, (arch, shape)


def test_model_flops_estimate_moe_discount():
    """`tests/test_system.py::test_model_flops_estimate_moe_discount`."""
    dense, moe = get_config("qwen2_72b"), get_config("moonshot_v1_16b_a3b")
    fd = A.model_flops_estimate(dense, "train", 128, 2)
    fm = A.model_flops_estimate(moe, "train", 128, 2)
    assert fm < 6 * T.param_count(moe) * 256
    assert fd == pytest.approx(6 * T.param_count(dense) * 256, rel=1e-6)


def test_roofline_terms_and_dominance():
    """`tests/test_system.py::test_roofline_terms_and_dominance` on the
    H100's constants; no collective term (none is counted)."""
    r = A.Roofline(flops=A.PEAK_FLOPS, hbm_bytes=A.HBM_BW * 2, chips=1)
    assert abs(r.compute_s - 1.0) < 1e-9
    assert abs(r.memory_s - 2.0) < 1e-9
    assert r.collective_s is None
    assert r.dominant == "memory"
    assert abs(r.roofline_fraction() - 0.5) < 1e-9
    d = r.as_dict()
    assert d["dominant"] == "memory"
    assert d["collective_bytes_per_device"] is None
    assert "co-locates" in d["collectives_note"]
    assert (A.PEAK_FLOPS, A.HBM_BW, A.NVLINK_BW) == (989e12, 3.35e12, 450e9)
    assert A.Roofline(flops=A.PEAK_FLOPS * 3, hbm_bytes=A.HBM_BW,
                      chips=1).dominant == "compute"


# ------------------------------------------------------------ counter
def test_traced_cost_counts_matmul_flops():
    """`tests/test_system.py::test_traced_cost_counts_matmul_flops`."""
    a = SP.sds((128, 256), torch.float32)
    b = SP.sds((256, 64), torch.float32)
    c = traced_cost(lambda a, b: a @ b, a, b)
    assert c.flops == 2 * 128 * 256 * 64
    assert c.bytes == 4 * (128 * 256 + 256 * 64 + 128 * 64)


def test_traced_cost_scan_multiplies():
    """`tests/test_system.py::test_traced_cost_scan_multiplies`."""
    def f(x):
        y, _ = scan(lambda c, _: (c @ c, None), x, 5)
        return y

    x = SP.sds((32, 32), torch.float32)
    c = traced_cost(f, x)
    assert c.flops == 5 * 2 * 32 * 32 * 32
    assert traced_cost(f, x, scale_loops=False).flops == c.flops


def _reference_dots(jcfg, kind):
    jp = JT.abstract_params(jcfg)
    if kind == "prefill":
        b = j_specs.train_batch_specs(jcfg, S, B)
        jpr = jax.make_jaxpr(lambda p, t, e: JT.prefill(
            jcfg, p, t, e, q_chunk=8))(jp, b["tokens"], b.get("extras"))
    elif kind == "decode":
        jpr = jax.make_jaxpr(lambda p, s, t: JT.decode_step(jcfg, p, s, t))(
            jp, j_specs.decode_state_specs(jcfg, B, S),
            j_specs.sds((B, 1), jnp.int32))
    else:
        step = j_make_train_step(jcfg, q_chunk=8, loss_chunk=8)
        jpr = jax.make_jaxpr(step)(jp, jax.eval_shape(j_init_opt_state, jp),
                                   j_specs.train_batch_specs(jcfg, S, B))
    return jaxpr_cost_breakdown(jpr)["dot_general"].flops


def _cell(cfg, kind, seq=S):
    """(fn, args) of one SMOKE cell on `meta`."""
    params = T.abstract_params(cfg)
    if kind == "prefill":
        b = SP.train_batch_specs(cfg, seq, B)

        def fn(p, t, e):
            with torch.no_grad():
                return T.prefill(cfg, p, t, e, q_chunk=8)
        return fn, (params, b["tokens"], b.get("extras"))
    if kind == "decode":
        def fn(p, s, t):
            with torch.no_grad():
                return T.decode_step(cfg, p, s, t)
        return fn, (params, SP.decode_state_specs(cfg, B, seq),
                    SP.sds((B, 1), torch.int32))
    step = make_train_step(cfg, q_chunk=8, loss_chunk=8)
    return step, (params, init_opt_state(params),
                  SP.train_batch_specs(cfg, seq, B))


@pytest.mark.parametrize("arch,kind,rtol", [
    ("granite_3_2b", "prefill", 1e-6), ("granite_3_2b", "decode", 1e-6),
    ("granite_3_2b", "train", 1e-2),
    ("moonshot_v1_16b_a3b", "prefill", 1e-6),
    ("moonshot_v1_16b_a3b", "decode", 1e-6),
    ("moonshot_v1_16b_a3b", "train", 1e-2),
    ("falcon_mamba_7b", "train", 1e-2), ("jamba_1_5_large_398b", "train", 1e-2),
    ("llama_3_2_vision_11b", "train", 1e-2),
    ("seamless_m4t_large_v2", "train", 1e-2)])
def test_matmul_flops_equal_the_reference_dots(arch, kind, rtol):
    want = _reference_dots(j_get_smoke(arch), kind)
    fn, args = _cell(get_smoke(arch), kind)
    got = matmul_flops(traced_cost_breakdown(fn, *args))
    assert got == pytest.approx(want, rel=rtol)
    if arch in ("granite_3_2b", "moonshot_v1_16b_a3b"):
        assert got == want


def _deeper(arch, periods=4):
    """SMOKE widths with `periods` periods (encoder layers too), so the
    period loop runs above 3 trips."""
    cfg = get_smoke(arch)
    return dataclasses.replace(cfg, num_layers=cfg.period() * periods,
                               enc_layers=cfg.enc_layers and periods)


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_scaled_loops_count_what_the_full_loops_count(arch, kind):
    """With loop scaling a loop of n > 3 trips runs its first, one
    middle and its last trip (the middle one counted n - 2 times): the
    count equals the full loops' op for op, FLOPs and bytes, forward,
    backward and recomputation.  Periods 4, q-chunks and loss chunks 4,
    Mamba time steps 32."""
    cfg = _deeper(arch)
    fn, args = _cell(cfg, kind)
    scaled = traced_cost_breakdown(fn, *args)
    full = traced_cost_breakdown(fn, *args, scale_loops=False)
    assert scaled == full


def test_scaled_mamba_chunk_loop_counts_what_the_full_loop_counts():
    """The Mamba chunk loop (256-step chunks) above 3 trips, nested in
    the period loop, under training's remat."""
    cfg = dataclasses.replace(get_smoke("falcon_mamba_7b"), num_layers=1)
    fn, args = _cell(cfg, "train", seq=1024)
    args = (args[0], args[1], {k: v[:1] for k, v in args[2].items()})
    scaled = traced_cost_breakdown(fn, *args)
    assert scaled == traced_cost_breakdown(fn, *args, scale_loops=False)


def test_loop_scaling_leaves_no_hook_behind():
    from repro_torch.nn import scan as scan_mod
    x = SP.sds((4, 4), torch.float32)
    traced_cost(lambda x: scan(lambda c, _: (c @ c, None), x, 9), x)
    assert scan_mod._HOOK is None
    with pytest.raises(RuntimeError):
        traced_cost(lambda x: traced_cost(lambda y: y @ y, x), x)
    assert scan_mod._HOOK is None


# ------------------------------------------------------------ dry run
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_run_cell_on_the_single_mesh(arch, tmp_path):
    """Every shape of the arch on the (16, 16) mesh: ok where
    `shape_applicable` says so, skipped where not, with the reference's
    record fields (the counted FLOPs and bytes under the port's
    names)."""
    cfg = get_config(arch)
    for shape, info in SP.SHAPES.items():
        rec = D.run_cell(arch, shape, "single", tmp_path)
        ok, why = SP.shape_applicable(cfg, shape)
        assert rec["status"] == ("ok" if ok else "skipped"), rec.get("error")
        on_disk = json.loads(
            (tmp_path / f"{arch}__{shape}__single.json").read_text())
        assert on_disk["status"] == rec["status"] and rec["chips"] == 256
        if not ok:
            assert rec["skipped"] == why
            continue
        assert (rec["kind"], rec["seq"], rec["batch"]) == (
            info["kind"], info["seq"], info["batch"])
        r = rec["roofline"]
        assert r["chips"] == 256 and r["collective_bytes_per_device"] is None
        assert r["flops_per_device"] * 256 == pytest.approx(
            rec["op_flops_global"])
        assert r["dominant"] in ("compute", "memory")
        assert rec["model_flops_global"] == A.model_flops_estimate(
            cfg, info["kind"], info["seq"], info["batch"])
        assert rec["model_flops_ratio"] == pytest.approx(
            rec["model_flops_global"] / rec["op_flops_global"])
        assert rec["op_bytes_global"] > 0
        assert rec["memory"]["argument_bytes"] > 0
        assert rec["memory"]["temp_bytes"] is None


def test_dryrun_main_writes_its_records(tmp_path, capsys):
    assert D.main(["--arch", "granite_3_2b", "--mesh", "single", "--out",
                   str(tmp_path)]) == 0
    text = capsys.readouterr().out
    assert "done: 3 ok, 1 skipped, 0 errors" in text
    assert len(list(tmp_path.glob("granite_3_2b__*__single.json"))) == 4


def test_argument_bytes_divide_by_the_sharded_axes():
    mesh = D.make_production_mesh(device="cpu")
    cell, _ = D.lower_cell("granite_3_2b", "decode_32k", mesh)
    params, state, tok = cell.args
    # the KV cache (nper, B, S, KV, hd) shards batch over data and seq
    # over model: 1/256 of it a device
    k = state["layers"]["slot0"]["k"]
    only_k = D.argument_bytes(
        ({"k": k},), ({"k": cell.pspecs[1]["layers"]["slot0"]["k"]},), mesh)
    assert only_k == k.numel() * k.element_size() // 256
