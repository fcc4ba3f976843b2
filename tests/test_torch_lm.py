"""The LM side stack on the port, training half (`repro_torch.nn`,
`configs/`, the LM steps of `training/train_lib.py`, the token stream,
`launch/train.py --arch`) against the reference.

- Configs, parameter counts and the MoE routing (top-k, capacity, drops)
  are exactly the reference's; the tokens integer for integer.
- fp32 parity, one config of each family (granite, moonshot, falcon,
  jamba, llama-vision, seamless), each SMOKE copied to
  `dtype="float32"`: loss within rtol 1e-5 and every gradient leaf
  within rtol 1e-4, atol 1e-6 of `jax.value_and_grad` on the same numpy
  weights.  The weights are drawn by numpy at std 0.02 (norms ones,
  biases zeros, as the specs ask): at the reference's own `init_params`
  scale (a stacked leaf's fan-in is its period count, so jamba's Mamba
  activations reach 1e10) both fp32 packages lie further than these
  tolerances from a float64 evaluation of the same loss (the reference
  ~2e-5 on jamba's loss, up to 1e-1 on a gradient leaf), and neither
  can be held to the other there.
- The configs' own bf16 compute on the same numpy weights: loss within
  rtol 2e-2 of the reference's (bf16 rounding of every activation); the
  reference's own `init_params` weights train in the port's bf16 too.
- `tests/test_arch_smoke.py`'s train step for all ten architectures,
  `tests/test_training.py`'s grad accumulation and loss descent, and the
  launcher end to end on the CPU; one SMOKE step on the card against the
  CPU (`cuda` marker).
"""
import _torch_cpu  # noqa: F401  (this worker's share of the cores)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import get_smoke as j_get_smoke
from repro.data import pipeline as j_pipeline
from repro.launch import specs as j_specs
from repro.nn import moe as JM
from repro.nn import transformer as JT
from repro.nn.param import ParamSpec as JParamSpec
from repro.training import optimizer as j_opt
from repro.training import train_lib as j_train
from repro_torch.configs import ARCH_IDS, all_configs, get_config, get_smoke
from repro_torch.data.pipeline import SyntheticTokenStream
from repro_torch.interop import load_reference_lm_params
from repro_torch.launch import specs as SP
from repro_torch.launch import train as t_train
from repro_torch.nn import moe as TM
from repro_torch.nn import transformer as T
from repro_torch.training.optimizer import (init_opt_state, tree_leaves,
                                            tree_map)
from repro_torch.training.train_lib import (make_grad_accum_train_step,
                                            make_loss_fn, make_train_step,
                                            value_and_grad)

B, S = 2, 16
FAMILIES = ["granite_3_2b", "moonshot_v1_16b_a3b", "falcon_mamba_7b",
            "jamba_1_5_large_398b", "llama_3_2_vision_11b",
            "seamless_m4t_large_v2"]
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
BF16_LOSS_RTOL = 2e-2


def _batch_np(cfg, key=0, b=B, s=S, embeds=np.float32):
    rng = np.random.default_rng(key)
    batch = {
        "tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
        "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
    }
    extras = {}
    if cfg.family == "vlm":
        extras["image_embeds"] = rng.standard_normal(
            (b, cfg.n_patches, cfg.d_model)).astype(embeds)
    if cfg.family == "encdec":
        extras["frames"] = rng.standard_normal(
            (b, s, cfg.d_model)).astype(embeds)
    if extras:
        batch["extras"] = extras
    return batch


def _to_torch(batch, device="cpu"):
    return tree_map(lambda a: torch.from_numpy(np.asarray(a)).to(device),
                    batch)


def _np_weights(jcfg, seed=1):
    """Weights for both packages, drawn by numpy from the reference's
    specs: normal leaves at std 0.02, "ones" / "zeros" as declared."""
    rng = np.random.default_rng(seed)

    def draw(s):
        if s.init == "zeros":
            return np.zeros(s.shape, np.float32)
        if s.init == "ones":
            return np.ones(s.shape, np.float32)
        return (rng.standard_normal(s.shape) * 0.02).astype(np.float32)
    return jax.tree.map(draw, JT.model_specs(jcfg),
                        is_leaf=lambda x: isinstance(x, JParamSpec))


def _leaf(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


# ------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_equal_the_reference(arch):
    for ours, ref in ((get_config(arch), j_get_config(arch)),
                      (get_smoke(arch), j_get_smoke(arch))):
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        assert (ours.padded_vocab, ours.hd, ours.d_inner, ours.period(),
                ours.layer_kinds(), ours.layer_is_moe(),
                ours.active_params_per_token_factor()) == (
            ref.padded_vocab, ref.hd, ref.d_inner, ref.period(),
            ref.layer_kinds(), ref.layer_is_moe(),
            ref.active_params_per_token_factor())
    assert get_config(arch.replace("_", "-")) == get_config(arch)


def test_param_counts_equal_the_reference():
    counts = {a: T.param_count(c) for a, c in all_configs().items()}
    assert counts == {a: JT.param_count(j_get_config(a)) for a in ARCH_IDS}
    assert counts["granite_3_2b"] == 2_534_049_792


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_config_matches_assignment(arch):
    """The FULL config carries the exact assigned hyperparameters."""
    cfg = get_config(arch)
    expect = {
        "internlm2_20b": (48, 6144, 48, 8, 16384, 92544),
        "minicpm_2b": (40, 2304, 36, 36, 5760, 122753),
        "granite_3_2b": (40, 2048, 32, 8, 8192, 49155),
        "qwen2_72b": (80, 8192, 64, 8, 29568, 152064),
        "llama4_scout_17b_a16e": (48, 5120, 40, 8, 8192, 202048),
        "moonshot_v1_16b_a3b": (48, 2048, 16, 16, 1408, 163840),
        "jamba_1_5_large_398b": (72, 8192, 64, 8, 24576, 65536),
        "llama_3_2_vision_11b": (40, 4096, 32, 8, 14336, 128256),
        "falcon_mamba_7b": (64, 4096, 0, 0, 0, 65024),
        "seamless_m4t_large_v2": (24, 1024, 16, 16, 8192, 256206),
    }[arch]
    got = (cfg.num_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
           cfg.d_ff, cfg.vocab_size)
    assert got == expect, (got, expect)
    assert cfg.compute_dtype == torch.bfloat16


def test_moe_configs():
    l4 = get_config("llama4_scout_17b_a16e")
    assert (l4.n_experts, l4.top_k) == (16, 1)
    ms = get_config("moonshot_v1_16b_a3b")
    assert (ms.n_experts, ms.top_k) == (64, 6)
    jb = get_config("jamba_1_5_large_398b")
    assert (jb.n_experts, jb.top_k) == (16, 2)
    assert jb.attn_every == 8          # 1:7 attention:mamba interleave
    assert jb.subquadratic


def test_param_counts_plausible():
    def count(arch):
        return T.param_count(get_config(arch))
    assert 15e9 < count("internlm2_20b") < 25e9
    assert 2e9 < count("minicpm_2b") < 4e9
    assert 60e9 < count("qwen2_72b") < 85e9
    assert 6e9 < count("falcon_mamba_7b") < 9e9
    assert 250e9 < count("jamba_1_5_large_398b") < 500e9
    assert 90e9 < count("llama4_scout_17b_a16e") < 130e9


def test_shape_applicability():
    """long_500k runs only on sub-quadratic archs; dense archs skip."""
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        ok, why = SP.shape_applicable(cfg, "long_500k")
        assert ok == cfg.subquadratic
        assert (ok, why) == j_specs.shape_applicable(j_get_config(arch),
                                                     "long_500k")
        ok4, _ = SP.shape_applicable(cfg, "train_4k")
        assert ok4
    assert SP.SHAPES == j_specs.SHAPES


def test_token_stream_equals_the_reference():
    for kw in (dict(seed=7), dict(seed=7, shard=1, num_shards=2),
               dict(seed=0, start_batch=5)):
        ours = SyntheticTokenStream(49155, 2, 33, **kw)
        ref = j_pipeline.SyntheticTokenStream(49155, 2, 33, **kw)
        for _ in range(3):
            a, b = next(ours), next(ref)
            assert a["tokens"].dtype == np.int32
            np.testing.assert_array_equal(a["tokens"], b["tokens"])
            np.testing.assert_array_equal(a["labels"], b["labels"])
        ours.seek(1)
        ref.seek(1)
        np.testing.assert_array_equal(next(ours)["tokens"],
                                      next(ref)["tokens"])


# ---------------------------------------------------------- train step
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_train_step(arch):
    """`tests/test_arch_smoke.py::test_smoke_train_step`: one step is
    finite and positive, and a second step changes the loss."""
    cfg = get_smoke(arch)
    params = T.init_params(cfg, seed=0, device="cpu")
    opt = init_opt_state(params)
    step = make_train_step(cfg, q_chunk=8, loss_chunk=8)
    batch = _to_torch(_batch_np(cfg, embeds=np.float32))
    params, opt, metrics = step(params, opt, batch)
    loss = float(metrics["loss"])
    assert np.isfinite(loss) and loss > 0
    _, _, m2 = step(params, opt, batch)
    assert np.isfinite(float(m2["loss"]))
    assert float(m2["loss"]) != loss


@pytest.mark.parametrize("arch", FAMILIES)
def test_fp32_loss_and_grads_equal_the_reference(arch):
    jcfg = dataclasses.replace(j_get_smoke(arch), dtype="float32")
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    weights = _np_weights(jcfg)
    batch = _batch_np(cfg)
    j_l, j_g = jax.value_and_grad(j_train.make_loss_fn(
        jcfg, q_chunk=8, loss_chunk=8))(jax.tree.map(jnp.asarray, weights),
                                        jax.tree.map(jnp.asarray, batch))
    t_l, t_g = value_and_grad(make_loss_fn(cfg, q_chunk=8, loss_chunk=8),
                              load_reference_lm_params(weights, "cpu"),
                              _to_torch(batch))
    np.testing.assert_allclose(float(t_l), float(j_l), rtol=LOSS_RTOL)
    leaves = jax.tree_util.tree_leaves_with_path(j_g)
    assert len(leaves) == len(tree_leaves(t_g))
    for path, g in leaves:
        np.testing.assert_allclose(
            _leaf(t_g, path).numpy(), np.asarray(g), rtol=GRAD_RTOL,
            atol=GRAD_ATOL, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("arch", FAMILIES)
def test_bf16_loss_equals_the_reference(arch):
    """The configs' own bf16 compute on the same numpy weights: loss
    within rtol 2e-2 of the reference's."""
    jcfg, cfg = j_get_smoke(arch), get_smoke(arch)
    weights = _np_weights(jcfg)
    batch = _batch_np(cfg)
    j_l = j_train.make_loss_fn(jcfg, q_chunk=8, loss_chunk=8)(
        jax.tree.map(jnp.asarray, weights), jax.tree.map(jnp.asarray, batch))
    with torch.no_grad():
        t_l = make_loss_fn(cfg, q_chunk=8, loss_chunk=8)(
            load_reference_lm_params(weights, "cpu"), _to_torch(batch))
    np.testing.assert_allclose(float(t_l), float(j_l), rtol=BF16_LOSS_RTOL)


@pytest.mark.parametrize("arch", FAMILIES)
def test_reference_init_trains_in_bf16(arch):
    """The reference's own `init_params` weights through one bf16 step
    of the port: a finite loss near the reference's (its Mamba blocks'
    activations reach 1e10 there, so bf16 rounding moves both packages'
    losses by percents: jamba's reference bf16 loss is 2.3% off its own
    fp32 one) that the step then changes."""
    jcfg, cfg = j_get_smoke(arch), get_smoke(arch)
    jp = JT.init_params(jcfg, jax.random.key(0))
    batch = _batch_np(cfg)
    j_l = j_train.make_loss_fn(jcfg, q_chunk=8, loss_chunk=8)(
        jp, jax.tree.map(jnp.asarray, batch))
    params = load_reference_lm_params(jax.tree.map(np.asarray, jp), "cpu")
    step = make_train_step(cfg, q_chunk=8, loss_chunk=8)
    params, opt, m = step(params, init_opt_state(params), _to_torch(batch))
    assert np.isfinite(float(m["loss"]))
    np.testing.assert_allclose(float(m["loss"]), float(j_l), rtol=5e-2)
    _, _, m2 = step(params, opt, _to_torch(batch))
    assert float(m2["loss"]) != float(m["loss"])


@pytest.mark.parametrize("arch", ["granite_3_2b", "moonshot_v1_16b_a3b"])
def test_fp32_train_step_equals_the_reference(arch):
    """One AdamW step (clip, schedule, decay) in both packages from the
    same weights: metrics and new parameters."""
    jcfg = dataclasses.replace(j_get_smoke(arch), dtype="float32")
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    weights = _np_weights(jcfg)
    batch = _batch_np(cfg)
    jp = jax.tree.map(jnp.asarray, weights)
    kw = dict(peak_lr=1e-2, warmup=1, total_steps=10, q_chunk=8,
              loss_chunk=8)
    j_p, j_o, j_m = j_train.make_train_step(jcfg, **kw)(
        jp, j_opt.init_opt_state(jp), jax.tree.map(jnp.asarray, batch))
    tp = load_reference_lm_params(weights, "cpu")
    t_p, t_o, t_m = make_train_step(cfg, **kw)(tp, init_opt_state(tp),
                                               _to_torch(batch))
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(t_m[k]), float(j_m[k]), rtol=1e-5)
    assert int(t_o["count"]) == int(j_o["count"]) == 1
    # the moments are linear in the gradients (held as they are); a first
    # AdamW step moves an element by lr * g / (|g| + eps), so where |g|
    # lies in the gradients' fp32 noise its update is noise too: the new
    # parameters are held to 1% of the learning rate
    for name, ref, got, atol in (("m", j_o["m"], t_o["m"], GRAD_ATOL),
                                 ("v", j_o["v"], t_o["v"], GRAD_ATOL ** 2),
                                 ("params", j_p, t_p, 1e-2 * kw["peak_lr"])):
        for path, p in jax.tree_util.tree_leaves_with_path(ref):
            np.testing.assert_allclose(
                _leaf(got, path).numpy(), np.asarray(p), rtol=2 * GRAD_RTOL,
                atol=atol, err_msg=name + jax.tree_util.keystr(path))


def test_donated_step_equals_the_returned_one():
    """`donate=True` (the launcher's step) writes the same values into
    the given tensors that the default step returns."""
    cfg = get_smoke("jamba_1_5_large_398b")
    params = T.init_params(cfg, seed=3, device="cpu")
    batch = _to_torch(_batch_np(cfg))
    kw = dict(peak_lr=1e-3, warmup=1, total_steps=10, q_chunk=8,
              loss_chunk=8)
    want_p, want_o, want_m = make_train_step(cfg, **kw)(
        params, init_opt_state(params), batch)
    mine = tree_map(torch.clone, params)
    ptrs = [t.data_ptr() for t in tree_leaves(mine)]
    got_p, got_o, got_m = make_train_step(cfg, donate=True, **kw)(
        mine, init_opt_state(mine), batch)
    assert [t.data_ptr() for t in tree_leaves(got_p)] == ptrs
    assert float(got_m["loss"]) == float(want_m["loss"])
    for a, b in zip(tree_leaves((got_p, got_o)), tree_leaves((want_p,
                                                              want_o))):
        assert torch.equal(a, b)


# ---------------------------------------------------------------- MoE
@pytest.mark.parametrize("arch", ["moonshot_v1_16b_a3b",
                                  "jamba_1_5_large_398b",
                                  "llama4_scout_17b_a16e"])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_routing_and_drops_equal_the_reference(arch, capacity_factor):
    """The dense dispatch's top-k experts, capacity, kept tokens and
    buffer slots exactly the reference's (its lines, in fp32), and the
    layer's output within fp32 rounding of the reference's."""
    jcfg = dataclasses.replace(j_get_smoke(arch), dtype="float32")
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    slot = next(k for k, m in zip(range(cfg.period()), cfg.layer_is_moe())
                if m)
    p = jax.tree.map(lambda t: np.asarray(t)[0], _np_weights(jcfg, seed=4)[
        "layers"][f"slot{slot}"]["ffn"])
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)

    t, d = B * S, cfg.d_model
    e, k = jcfg.n_experts, jcfg.top_k
    xf = jnp.asarray(x).reshape(t, d)
    probs = jax.nn.softmax(xf @ jnp.asarray(p["router"]), axis=-1)
    top_p, top_i = jax.lax.top_k(probs, k)
    cap = int(np.ceil(t * k / e * capacity_factor))
    flat_e = top_i.reshape(-1)
    order = jnp.argsort(flat_e)
    ge = flat_e[order]
    gt = jnp.repeat(jnp.arange(t), k)[order]
    pos = jnp.arange(t * k) - jnp.searchsorted(ge, jnp.arange(e))[ge]
    keep = pos < cap
    slot_ = jnp.where(keep, ge * cap + pos, e * cap)

    r = TM.route(cfg, torch.from_numpy(p["router"]),
                 torch.from_numpy(x).reshape(t, d), capacity_factor)
    assert r["cap"] == cap
    for name, ref in (("top_i", top_i), ("ge", ge), ("gt", gt),
                      ("pos", pos), ("keep", keep), ("slot", slot_)):
        np.testing.assert_array_equal(r[name].numpy(), np.asarray(ref),
                                      err_msg=name)
    if capacity_factor < 1:
        assert not bool(np.asarray(keep).all())    # tokens were dropped
    want = JM.moe_ffn_dense(jcfg, jax.tree.map(jnp.asarray, p),
                            jnp.asarray(x), capacity_factor=capacity_factor)
    got = TM.moe_ffn_dense(cfg, load_reference_lm_params(p, "cpu"),
                           torch.from_numpy(x),
                           capacity_factor=capacity_factor)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(
        float(TM.aux_load_balance_loss(cfg, load_reference_lm_params(
            p, "cpu"), torch.from_numpy(x))),
        float(JM.aux_load_balance_loss(jcfg, jax.tree.map(jnp.asarray, p),
                                       jnp.asarray(x))), rtol=1e-6)


# -------------------------------------------------- test_training.py
def test_grad_accum_matches_full_batch():
    """`tests/test_training.py::test_grad_accum_matches_full_batch`."""
    cfg = get_smoke("granite_3_2b")
    params = T.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    batch = _to_torch({
        "tokens": rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32),
        "labels": rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32),
    })
    step_full = make_train_step(cfg, q_chunk=8, loss_chunk=8)
    step_acc = make_grad_accum_train_step(cfg, micro_steps=2, q_chunk=8,
                                          loss_chunk=8)
    p1, _, m1 = step_full(params, init_opt_state(params), batch)
    p2, _, m2 = step_acc(params, init_opt_state(params), batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-4)
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3,
                                   atol=2e-5)


def test_grad_accum_equals_the_reference():
    """The accumulated step against the reference's in fp32."""
    jcfg = dataclasses.replace(j_get_smoke("granite_3_2b"), dtype="float32")
    cfg = dataclasses.replace(get_smoke("granite_3_2b"), dtype="float32")
    weights = _np_weights(jcfg)
    batch = _batch_np(cfg, b=4)
    kw = dict(micro_steps=2, q_chunk=8, loss_chunk=8, peak_lr=1e-2,
              warmup=1, total_steps=10)
    jp = jax.tree.map(jnp.asarray, weights)
    _, _, j_m = j_train.make_grad_accum_train_step(jcfg, **kw)(
        jp, j_opt.init_opt_state(jp), jax.tree.map(jnp.asarray, batch))
    tp = load_reference_lm_params(weights, "cpu")
    _, _, t_m = make_grad_accum_train_step(cfg, **kw)(
        tp, init_opt_state(tp), _to_torch(batch))
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(t_m[k]), float(j_m[k]), rtol=1e-5)


def test_lm_loss_decreases():
    """`tests/test_training.py::test_lm_loss_decreases`: 40 steps on a
    tiny LM reduce the loss on a fixed batch."""
    cfg = get_smoke("minicpm_2b")
    params = T.init_params(cfg, seed=1, device="cpu")
    rng = np.random.default_rng(1)
    batch = _to_torch({
        "tokens": rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32),
        "labels": rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32),
    })
    step = make_train_step(cfg, peak_lr=3e-3, warmup=5, total_steps=60,
                           q_chunk=8, loss_chunk=8)
    opt = init_opt_state(params)
    losses = []
    for _ in range(40):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses[::8]


# ------------------------------------------------------------ launcher
def test_launcher_arch_runs_end_to_end_on_the_cpu(tmp_path, capsys):
    out = t_train.main(["--arch", "granite_3_2b", "--smoke", "--steps", "4",
                        "--device", "cpu", "--ckpt-dir", str(tmp_path),
                        "--ckpt-every", "2"])
    assert (out["start"], out["steps"], out["saves"]) == (0, 4, 2)
    assert len(out["losses"]) == 4 and all(np.isfinite(out["losses"]))
    assert len(set(out["losses"])) == 4
    text = capsys.readouterr().out
    assert "arch=granite-smoke params=0.1M" in text and "done: 4 steps" in text
    # resume from the newest checkpoint, as the reference's launcher does
    again = t_train.main(["--arch", "granite_3_2b", "--smoke", "--steps",
                          "6", "--device", "cpu", "--ckpt-dir",
                          str(tmp_path)])
    assert (again["start"], again["steps"]) == (4, 6)


@pytest.mark.parametrize("arch", ["llama_3_2_vision_11b",
                                  "seamless_m4t_large_v2"])
def test_launcher_build_feeds_the_stub_frontends(arch):
    """The vlm / encdec batches get their stub embeddings, the same on
    every replay of a batch, and a micro-stepped build trains."""
    mesh, step, state, data, cfg = t_train.build(
        arch, smoke=True, batch=2, seq=16, steps=5, micro_steps=2,
        q_chunk=8, loss_chunk=8, device="cpu")
    assert mesh.shape == {"data": 1, "model": 1}
    raw = next(data)
    b1 = t_train.batch_to_device(cfg, raw, torch.device("cpu"))
    b2 = t_train.batch_to_device(cfg, raw, torch.device("cpu"))
    (key, emb), = b1["extras"].items()
    assert emb.dtype == torch.bfloat16 and torch.equal(emb,
                                                       b2["extras"][key])
    _, opt, m = step(state["params"], state["opt"], b1)
    assert np.isfinite(float(m["loss"])) and int(opt["count"]) == 1


# ------------------------------------------------------------- the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", FAMILIES)
def test_card_smoke_step_matches_cpu(arch):
    """One fp32 SMOKE step on the card against the same step on the CPU."""
    dev = _card()
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    weights = _np_weights(dataclasses.replace(j_get_smoke(arch),
                                              dtype="float32"))
    batch = _batch_np(cfg)
    outs = []
    for d in ("cpu", dev):
        p = load_reference_lm_params(weights, d)
        new_p, _, m = make_train_step(cfg, q_chunk=8, loss_chunk=8)(
            p, init_opt_state(p), _to_torch(batch, d))
        outs.append((float(m["loss"]), [t.cpu() for t in
                                        tree_leaves(new_p)]))
    np.testing.assert_allclose(outs[1][0], outs[0][0], rtol=1e-5)
    for a, b in zip(outs[0][1], outs[1][1]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-4,
                                   atol=1e-6)
