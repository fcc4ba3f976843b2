"""Prefill and decode on the port (`nn/transformer.py::prefill`,
`decode_step`, `init_decode_state`, `fill_cross_kv`,
`nn/layers.py::attention_decode`, `nn/mamba.py::mamba_decode`, the
decode-state specs of `launch/specs.py`, `interop.py::
load_reference_decode_state`) against the reference.

- fp32, one config of each family (granite, moonshot, falcon-mamba,
  jamba, llama-vision, seamless), SMOKE copied to `dtype="float32"`, on
  numpy weights at std 0.02 (ROADMAP §C note 4): prefill's logits and
  every state leaf (`k`, `v`, `mk`, `mv`, `conv`, `ssm`), then three
  greedy `decode_step`s' logits and states, within rtol 1e-5, atol
  1e-6 of the reference's, `pos` exactly; and `decode_step` alone from
  the reference's own post-prefill state.  One reference prefill and
  decode per arch, shared by the file.
- The configs' own bf16 compute on the same weights: logits within rtol
  2e-2 (atol 2e-2 of the logits' largest magnitude, for the entries
  near zero) of the reference's.
- The twins of `tests/test_arch_smoke.py::test_smoke_prefill_decode`
  (all ten architectures) and `::test_smoke_decode_matches_prefill_
  suffix`; a write at `pos >= max_len` clamps to the last slot, as the
  reference's `dynamic_update_slice` does; the decode-state specs tuple
  for tuple (`tests/test_sharding_specs.py`); an MoE model decoding on a
  (2, 4) mesh through the all-to-all dispatch; one step on the card
  against the CPU (`cuda` marker).
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
from repro.launch import specs as j_specs
from repro.launch.mesh import single_device_mesh as j_single_mesh
from repro.nn import transformer as JT
from repro.nn.param import ParamSpec as JParamSpec
from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.distributed.sharding import Constrainer
from repro_torch.interop import (load_reference_decode_state,
                                 load_reference_lm_params)
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.launch.mesh import single_device_mesh
from repro_torch.nn import moe as TM
from repro_torch.nn import transformer as T

B, S, EXTRA = 2, 16, 4
FAMILIES = ["granite_3_2b", "moonshot_v1_16b_a3b", "falcon_mamba_7b",
            "jamba_1_5_large_398b", "llama_3_2_vision_11b",
            "seamless_m4t_large_v2"]
RTOL, ATOL = 1e-5, 1e-6
BF16_RTOL = 2e-2
DECODES = 3


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


def _inputs(cfg, key=0, b=B, s=S):
    rng = np.random.default_rng(key)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    extras = {}
    if cfg.family == "vlm":
        extras["image_embeds"] = rng.standard_normal(
            (b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        extras["frames"] = rng.standard_normal(
            (b, s, cfg.d_model)).astype(np.float32)
    return toks, extras


def _t(tree, device="cpu"):
    if isinstance(tree, dict):
        return {k: _t(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree)).to(device)


def _greedy(logits, cfg):
    return (np.argmax(np.asarray(logits, np.float32), -1).astype(np.int32)
            [:, None] % cfg.vocab_size)


def _state_np(state):
    return {"pos": np.asarray(state["pos"]),
            "layers": {slot: {k: np.asarray(v, np.float32)
                              for k, v in st.items()}
                       for slot, st in state["layers"].items()}}


def _port_state_np(state):
    """A numpy copy (decode writes the state's tensors in place)."""
    return {"pos": state["pos"].cpu().numpy().copy(),
            "layers": {slot: {k: v.float().cpu().numpy().copy()
                              for k, v in st.items()}
                       for slot, st in state["layers"].items()}}


def _reference_run(jcfg, weights, toks, extras):
    """The reference's prefill and `DECODES` greedy decode steps: the
    logits and (numpy) state after each."""
    jp = jax.tree.map(jnp.asarray, weights)
    logits, state = jax.jit(lambda p, t, e: JT.prefill(
        jcfg, p, t, e, q_chunk=8, max_len=S + EXTRA))(
        jp, jnp.asarray(toks), jax.tree.map(jnp.asarray, extras))
    out = [(np.asarray(logits, np.float32), _state_np(state))]
    dec = jax.jit(lambda p, s, t: JT.decode_step(jcfg, p, s, t))
    for _ in range(DECODES):
        tok = _greedy(out[-1][0], jcfg)
        logits, state = dec(jp, state, jnp.asarray(tok))
        out.append((np.asarray(logits, np.float32), _state_np(state)))
    return out


@pytest.fixture(scope="module")
def reference():
    """One reference run per (arch, dtype), shared by the file."""
    cache = {}

    def get(arch, dtype="float32"):
        if (arch, dtype) not in cache:
            jcfg = dataclasses.replace(j_get_smoke(arch), dtype=dtype)
            weights = _np_weights(dataclasses.replace(j_get_smoke(arch),
                                                      dtype="float32"))
            toks, extras = _inputs(jcfg)
            cache[arch, dtype] = (weights, toks, extras,
                                  _reference_run(jcfg, weights, toks, extras))
        return cache[arch, dtype]
    return get


def _port_run(cfg, weights, toks, extras, device="cpu"):
    params = load_reference_lm_params(weights, device)
    out = []
    with torch.no_grad():
        logits, state = T.prefill(cfg, params, _t(toks, device),
                                  _t(extras, device), q_chunk=8,
                                  max_len=S + EXTRA)
        out.append((logits.float().cpu().numpy(), _port_state_np(state)))
        for _ in range(DECODES):
            tok = _greedy(out[-1][0], cfg)
            logits, state = T.decode_step(cfg, params, state,
                                          _t(tok, device))
            out.append((logits.float().cpu().numpy(),
                        _port_state_np(state)))
    return out


def _assert_states(got, want, where, **tol):
    np.testing.assert_array_equal(got["pos"], want["pos"], err_msg=where)
    assert got["pos"].dtype == np.int32 and got["pos"].shape == ()
    assert got["layers"].keys() == want["layers"].keys()
    for slot, st in want["layers"].items():
        assert got["layers"][slot].keys() == st.keys(), (where, slot)
        for k, v in st.items():
            np.testing.assert_allclose(got["layers"][slot][k], v,
                                       err_msg=f"{where} {slot}/{k}", **tol)


@pytest.mark.parametrize("arch", FAMILIES)
def test_fp32_prefill_and_decode_equal_the_reference(arch, reference):
    weights, toks, extras, want = reference(arch)
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    got = _port_run(cfg, weights, toks, extras)
    for i, ((gl, gs), (wl, ws)) in enumerate(zip(got, want)):
        where = "prefill" if i == 0 else f"decode {i}"
        np.testing.assert_allclose(gl, wl, rtol=RTOL, atol=ATOL,
                                   err_msg=where)
        _assert_states(gs, ws, where, rtol=RTOL, atol=ATOL)
    assert int(got[-1][1]["pos"]) == S + DECODES


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_step_alone_from_the_reference_state(arch, reference):
    """`decode_step` from the reference's post-prefill state, carried
    across by `load_reference_decode_state`, gives the reference's first
    decode."""
    weights, toks, extras, want = reference(arch)
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    state = load_reference_decode_state(want[0][1], "cpu")
    assert state["pos"].dtype == torch.int32 and state["pos"].dim() == 0
    with torch.no_grad():
        logits, state = T.decode_step(
            cfg, load_reference_lm_params(weights, "cpu"), state,
            _t(_greedy(want[0][0], cfg)))
    np.testing.assert_allclose(logits.numpy(), want[1][0], rtol=RTOL,
                               atol=ATOL)
    _assert_states(_port_state_np(state), want[1][1], "decode 1",
                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("arch", FAMILIES)
def test_bf16_prefill_and_decode_equal_the_reference(arch, reference):
    """The configs' own bf16 compute: the prefill logits and each decode
    step's logits (fed the reference's greedy tokens) within rtol 2e-2."""
    weights, toks, extras, want = reference(arch, "bfloat16")
    cfg = get_smoke(arch)
    params = load_reference_lm_params(weights, "cpu")
    with torch.no_grad():
        logits, state = T.prefill(cfg, params, _t(toks), _t(extras),
                                  q_chunk=8, max_len=S + EXTRA)
        got = [logits.float().numpy()]
        for i in range(DECODES):
            logits, state = T.decode_step(cfg, params, state,
                                          _t(_greedy(want[i][0], cfg)))
            got.append(logits.float().numpy())
    for i, (g, (w, _)) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, rtol=BF16_RTOL,
                                   atol=BF16_RTOL * np.abs(w).max(),
                                   err_msg=f"step {i}")
    assert int(state["pos"]) == S + DECODES
    # the reference's own bf16 state, carried across: its K/V stay bf16
    jcfg = j_get_smoke(arch)
    ref_state = jax.jit(lambda p, t, e: JT.prefill(
        jcfg, p, t, e, q_chunk=8, max_len=S + EXTRA)[1])(
        jax.tree.map(jnp.asarray, weights), jnp.asarray(toks),
        jax.tree.map(jnp.asarray, extras))
    carried = load_reference_decode_state(
        jax.tree.map(np.asarray, ref_state), "cpu")
    for slot, st in ref_state["layers"].items():
        for k, v in st.items():
            assert str(carried["layers"][slot][k].dtype).endswith(
                str(v.dtype)), (slot, k)
    with torch.no_grad():
        logits, _ = T.decode_step(cfg, params, carried,
                                  _t(_greedy(want[0][0], cfg)))
    np.testing.assert_allclose(logits.float().numpy(), want[1][0],
                               rtol=BF16_RTOL,
                               atol=BF16_RTOL * np.abs(want[1][0]).max())


# ------------------------------------------------ test_arch_smoke.py
def _smoke_batch(cfg, key):
    rng = np.random.default_rng(key)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32))
    extras = {}
    if cfg.family == "vlm":
        extras["image_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)).bfloat16()
    if cfg.family == "encdec":
        extras["frames"] = torch.from_numpy(rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)).bfloat16()
    return toks, extras


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_prefill_decode(arch):
    """`tests/test_arch_smoke.py::test_smoke_prefill_decode`."""
    cfg = get_smoke(arch)
    params = T.init_params(cfg, seed=1, device="cpu")
    toks, extras = _smoke_batch(cfg, 1)
    with torch.no_grad():
        logits, state = T.prefill(cfg, params, toks, extras, max_len=S + 4)
        assert logits.shape == (B, cfg.padded_vocab)
        assert logits.dtype == torch.float32
        assert torch.isfinite(logits).all()
        assert state["pos"].dtype == torch.int32 and int(state["pos"]) == S
        tok = (torch.argmax(logits, -1).to(torch.int32)[:, None]
               % cfg.vocab_size)
        for _ in range(3):
            logits, state = T.decode_step(cfg, params, state, tok)
            assert logits.shape == (B, cfg.padded_vocab)
            assert torch.isfinite(logits).all()
            tok = (torch.argmax(logits, -1).to(torch.int32)[:, None]
                   % cfg.vocab_size)
    assert int(state["pos"]) == S + 3


def test_smoke_decode_matches_prefill_suffix():
    """`tests/test_arch_smoke.py::test_smoke_decode_matches_prefill_
    suffix`: prefill on k+1 tokens gives the logits of prefill(k) then
    decode(token k+1)."""
    cfg = get_smoke("granite_3_2b")
    params = T.init_params(cfg, seed=2, device="cpu")
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 8)).astype(
        np.int32))
    with torch.no_grad():
        lg_full, _ = T.prefill(cfg, params, toks, max_len=8)
        lg_pre, state = T.prefill(cfg, params, toks[:, :7], max_len=8)
        lg_dec, _ = T.decode_step(cfg, params, state, toks[:, 7:8])
    np.testing.assert_allclose(lg_dec.numpy(), lg_full.numpy(), rtol=3e-2,
                               atol=3e-2)


def test_write_past_max_len_clamps_as_the_reference(reference):
    """At pos >= max_len the reference's `dynamic_update_slice` clamps
    its start: the token's K/V overwrite the last slot and every slot
    is attended to.  The port does the same (no index error, no
    device-side assert)."""
    arch = "granite_3_2b"
    jcfg = dataclasses.replace(j_get_smoke(arch), dtype="float32")
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    weights = _np_weights(jcfg)
    toks, _ = _inputs(cfg)
    jp = jax.tree.map(jnp.asarray, weights)
    params = load_reference_lm_params(weights, "cpu")
    j_logits, j_state = JT.prefill(jcfg, jp, jnp.asarray(toks), q_chunk=8)
    with torch.no_grad():
        logits, state = T.prefill(cfg, params, _t(toks), q_chunk=8)
    for step in range(2):                  # pos = max_len, max_len + 1
        tok = _greedy(j_logits, jcfg)
        j_logits, j_state = JT.decode_step(jcfg, jp, j_state,
                                           jnp.asarray(tok))
        with torch.no_grad():
            logits, state = T.decode_step(cfg, params, state, _t(tok))
        np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                                   rtol=RTOL, atol=ATOL)
        _assert_states(_port_state_np(state), _state_np(j_state),
                       f"past max_len {step}", rtol=RTOL, atol=ATOL)
    assert int(state["pos"]) == S + 2


# ------------------------------------------------ decode-state specs
@pytest.mark.parametrize("arch", ["granite_3_2b", "falcon_mamba_7b",
                                  "jamba_1_5_large_398b",
                                  "llama_3_2_vision_11b",
                                  "seamless_m4t_large_v2",
                                  "moonshot_v1_16b_a3b"])
def test_decode_state_specs_equal_the_reference(arch):
    """`decode_state_specs` (`init_decode_state` on `meta`) and
    `decode_state_pspecs` tuple for tuple with the reference's, on the
    single-device mesh and the (16, 16) production mesh's shape."""
    jcfg, cfg = j_get_config(arch), get_config(arch)
    want = j_specs.decode_state_specs(jcfg, 4, 64)
    got = SP.decode_state_specs(cfg, 4, 64)
    assert got["pos"].device.type == "meta" and got["pos"].shape == ()
    assert got["layers"].keys() == want["layers"].keys()
    for slot, st in want["layers"].items():
        assert got["layers"][slot].keys() == st.keys()
        for k, v in st.items():
            t = got["layers"][slot][k]
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(v.shape), (slot, k)
            assert str(t.dtype).split(".")[-1] == str(v.dtype), (slot, k)
    jmesh = j_single_mesh()
    pairs = [(jmesh, single_device_mesh("cpu"))]
    for jm, tm in pairs:
        wp = j_specs.decode_state_pspecs(jcfg, want, jm)
        gp = SP.decode_state_pspecs(cfg, got, tm)
        assert gp["pos"] == tuple(wp["pos"])
        for slot, st in wp["layers"].items():
            for k, v in st.items():
                assert tuple(gp["layers"][slot][k]) == tuple(v), (slot, k)
    # the production mesh's shape (the reference cannot build it on one
    # host; its rule is the shared `_pspec_from_logical`)
    ms = {"data": 16, "model": 16}
    big = SP.decode_state_pspecs(cfg, got, make_production_mesh(
        device="cpu"))
    for slot, st in got["layers"].items():
        for k, v in st.items():
            logical = j_specs.decode_state_logical(jcfg)[k]
            rules = {"batch": "data", "seq": "model", "mlp": "model"}
            assert tuple(big["layers"][slot][k]) == tuple(
                j_specs._pspec_from_logical(tuple(v.shape), logical, ms,
                                            rules)), (slot, k)


def test_decode_state_specs_cover_families():
    """`tests/test_sharding_specs.py::test_decode_state_specs_cover_
    families`."""
    for arch, keys in [("granite_3_2b", {"k", "v"}),
                       ("falcon_mamba_7b", {"conv", "ssm"}),
                       ("jamba_1_5_large_398b", {"k", "v", "conv", "ssm"}),
                       ("llama_3_2_vision_11b", {"k", "v", "mk", "mv"})]:
        st = SP.decode_state_specs(get_config(arch), 4, 64)
        names = set()
        for slot in st["layers"].values():
            names |= set(slot)
        assert keys <= names, (arch, names)


# ------------------------------------------------ MoE on a model axis
def test_moe_decodes_through_the_a2a_on_a_model_axis_above_one(monkeypatch):
    """moonshot SMOKE (fp32) prefills and decodes on a co-located (2, 4)
    mesh through `moe_ffn_a2a` (every MoE call), and with no token
    dropped (capacity factor 8.0) agrees with the dense dispatch on no
    mesh within `tests/test_moe_a2a.py`'s output tolerance."""
    from repro_torch.nn import moe_a2a as TA
    cfg = dataclasses.replace(get_smoke("moonshot_v1_16b_a3b"),
                              dtype="float32")
    weights = _np_weights(dataclasses.replace(
        j_get_smoke("moonshot_v1_16b_a3b"), dtype="float32"))
    params = load_reference_lm_params(weights, "cpu")
    toks, _ = _inputs(cfg)
    dispatch, a2a = TM.moe_ffn, TA.moe_ffn_a2a
    calls = []

    def counted(*a, **kw):
        calls.append(a[2].shape)
        return a2a(*a, **kw)

    monkeypatch.setattr(TA, "moe_ffn_a2a", counted)
    monkeypatch.setattr(TM, "moe_ffn", lambda cfg, p, x, sc=T.no_sc, **kw:
                        dispatch(cfg, p, x, sc, capacity_factor=8.0))
    sc = Constrainer(make_mesh((2, 4), ("data", "model"), device="cpu"))
    runs = []
    for c in (T.no_sc, sc):
        with torch.no_grad():
            lg, st = T.prefill(cfg, params, _t(toks), sc=c, q_chunk=8,
                               max_len=S + EXTRA)
            out = [lg]
            for _ in range(DECODES):
                lg, st = T.decode_step(cfg, params, st,
                                       _t(_greedy(out[0].numpy(), cfg)), c)
                out.append(lg)
        runs.append(out)
    n_moe = sum(cfg.layer_is_moe())
    assert calls == ([(B, S, cfg.d_model)] * n_moe
                     + [(B, 1, cfg.d_model)] * n_moe * DECODES)
    for want, got in zip(*runs):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                                   atol=2e-4)


# ---------------------------------------------------------- the card
@pytest.mark.cuda
@pytest.mark.parametrize("arch", FAMILIES)
def test_card_decode_step_matches_cpu(arch):
    """fp32 SMOKE prefill and three decode steps on the card against the
    same on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    weights = _np_weights(dataclasses.replace(j_get_smoke(arch),
                                              dtype="float32"))
    toks, extras = _inputs(cfg)
    cpu = _port_run(cfg, weights, toks, extras, "cpu")
    card = _port_run(cfg, weights, toks, extras, "cuda")
    for i, ((gl, gs), (wl, ws)) in enumerate(zip(card, cpu)):
        np.testing.assert_allclose(gl, wl, rtol=1e-4, atol=1e-5,
                                   err_msg=f"step {i}")
        _assert_states(gs, ws, f"step {i}", rtol=1e-4, atol=1e-5)
