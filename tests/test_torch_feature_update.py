"""B4, the fused linear + activation, against the reference on the CPU.

`fused_linear_act` (the plain version on CPU tensors) against the
reference's oracle `fused_linear_act_ref` and its Pallas kernel in
interpret mode, for each activation and ragged shapes (rtol=1e-5,
atol=1e-6: one fp32 product, summed in another order).  The CUDA kernel
is held to the plain version in the `cuda`-marked tests.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.feature_update import fused_linear_act as j_fused_linear_act
from repro.kernels.feature_update.ref import fused_linear_act_ref
from repro_torch.kernels import feature_update as t_fu
from repro_torch.kernels import launch_counts

RTOL, ATOL = 1e-5, 1e-6
ACTS = ["relu", "sigmoid", "tanh", "none"]
SHAPES = [(37, 21, 5), (64, 64, 64), (130, 70, 33), (1, 3, 1)]


def _inputs(n, k, h, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, k)).astype(np.float32)
    w = (rng.standard_normal((k, h)) / np.sqrt(k)).astype(np.float32)
    b = rng.standard_normal(h).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("n,k,h", SHAPES)
def test_matches_reference_oracle(act, n, k, h):
    x, w, b = _inputs(n, k, h)
    want = np.asarray(fused_linear_act_ref(jnp.asarray(x), jnp.asarray(w),
                                           jnp.asarray(b), act=act))
    got = t_fu.fused_linear_act(*(torch.from_numpy(a) for a in (x, w, b)),
                                act=act).numpy()
    assert got.shape == (n, h) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("act", ["relu", "tanh", "gelu"])
def test_matches_reference_kernel_without_bias(act):
    """The reference's entry point (its Pallas kernel, interpreted on the
    CPU; tiles smaller than the shapes so its wrapper pads), b=None; an
    unknown activation is the identity in both."""
    x, w, _ = _inputs(40, 24, 12, seed=1)
    want = np.asarray(j_fused_linear_act(jnp.asarray(x), jnp.asarray(w),
                                         act=act, tn=16, th=8, tf=16))
    got = t_fu.fused_linear_act(torch.from_numpy(x), torch.from_numpy(w),
                                act=act).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_forward_only_and_no_launch_on_the_cpu():
    x, w, b = (torch.from_numpy(a) for a in _inputs(8, 4, 3))
    before = launch_counts()
    with pytest.raises(NotImplementedError, match="forward only"):
        t_fu.fused_linear_act(x, w.clone().requires_grad_(True), b)
    with torch.no_grad():
        t_fu.fused_linear_act(x, w.clone().requires_grad_(True), b)
    assert launch_counts() == before
    with pytest.raises(ValueError, match="no feature_update"):
        t_fu.fused_linear_act(x.to("meta"), w.to("meta"))


# -- on the card -----------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("n,k,h", SHAPES + [(19717, 564, 64)])
def test_kernel_matches_plain_on_card(act, n, k, h):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    x, w, b = (torch.from_numpy(a).cuda() for a in _inputs(n, k, h))
    before = launch_counts()["feature_update_" + ("identity" if act == "none"
                                                   else act)]
    got = t_fu.fused_linear_act(x, w, b, act=act)
    want = t_fu.fused_linear_act_plain(x, w, b, act=act)
    assert (launch_counts()["feature_update_" + ("identity" if act == "none"
                                                 else act)] == before + 1)
    torch.testing.assert_close(got, want, rtol=RTOL,
                               atol=ATOL * max(1.0, float(want.abs().max())))
    with pytest.raises(ValueError, match="chain"):
        t_fu.fused_linear_act(x, w[:-1], b)
