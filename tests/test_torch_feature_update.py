"""B4, the fused linear + activation, against the reference on the CPU.

`fused_linear_act` (the plain version on CPU tensors) against the
reference's oracle `fused_linear_act_ref` and its Pallas kernel in
interpret mode, for each activation and ragged shapes (rtol=1e-5,
atol=1e-6: one fp32 product, summed in another order).  The CUDA kernel
is held to the plain version in the `cuda`-marked tests; the shapes that
take each of its paths (K or H not a multiple of 4: 4-byte copies; N not
a multiple of the row tile; each row tile the launcher picks on a
132-SM card, pubmed's 19,717 rows: 160, 16,000: 128; several column
tiles, H = 130 and 132; cora's K = 1,433; b=None) use small-integer
inputs scaled by a power of two, whose fp32 sums are exact in any order,
so the comparison sees the kernel's indexing and not its summation
order (at K = 1,433 two orders of random fp32 inputs differ by up to
5e-6, over the 1e-6 this file holds an activation in (-1, 1) to).
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



def _exact_inputs(n, k, h, seed=0):
    """x in {-2..2}, w and b in {-2..2} / 64: every product and partial
    sum is a multiple of 1/64 below 2^17, exact in fp32 in any order,
    and the pre-activations are O(1)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-2, 3, (n, k)).astype(np.float32)
    w = (rng.integers(-2, 3, (k, h)) / 64).astype(np.float32)
    b = (rng.integers(-2, 3, h) / 64).astype(np.float32)
    return x, w, b


@pytest.mark.cuda
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("n,k,h", [
    (19717, 500, 64), (16000, 100, 64), (33000, 500, 64), (2708, 1433, 64),
    (1000, 564, 130), (1000, 1433, 130), (517, 128, 132), (37, 21, 5)])
def test_kernel_paths_on_card(act, bias, n, k, h):
    """Each of the kernel's paths (row tiles, copy widths, column tiles,
    ragged edges, b=None) against the plain version on exact inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    x, w, b = (torch.from_numpy(a).cuda() for a in _exact_inputs(n, k, h))
    b = b if bias else None
    got = t_fu.fused_linear_act(x, w, b, act=act)
    want = t_fu.fused_linear_act_plain(x, w, b, act=act)
    if act in ("relu", "none"):
        assert torch.equal(got, want)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
