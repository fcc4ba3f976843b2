"""Force a multi-device host view for the whole suite.

Two reasons, both load-bearing on small CI machines:

- the ring/mesh tests shard over ``min(len(jax.devices()), 8)`` and
  only exercise real collectives under a multi-device view;
- XLA:CPU cannot re-enter itself from a host callback when the host
  has a single execution lane: a jitted program with compute around a
  ``pure_callback`` deadlocks while the streamed TiledExecutor sweep
  inside the callback (DESIGN.md C9/C10) waits for the core the outer
  program holds.  Forcing several host devices gives the nested
  dispatch its own lane, matching how the CPU launchers already run
  (launch/train.py documents the flag; launch/dryrun.py forces 512).

This must run before jax initialises its backends, hence conftest and
not a fixture.  An explicit user-provided device count is respected.

Setting the env var is a silent no-op when a jax backend already
initialised (e.g. a plugin or sitecustomize imported jax before pytest
collected this conftest): the suite would then run on ONE CPU lane and
the callback-loop tests above would deadlock, not fail.  `_assert_
multi_device_view` turns that into a loud, actionable error instead.
"""
import os
import sys

_FLAG = "--xla_force_host_platform_device_count"


def _assert_multi_device_view(count: int, who: str) -> None:
    """Fail loudly if the flag landed after the jax backend initialised.

    Only called when *we* just injected the flag — an explicit
    user-provided count is respected without checks.  Importing jax
    here is safe: if it was not imported yet, the backend initialises
    now, with the flag already in the environment.
    """
    if "jax" not in sys.modules:
        return  # backend cannot have initialised yet; flag will apply
    import jax

    if jax.default_backend() == "cpu" and jax.local_device_count() < count:
        raise RuntimeError(
            f"{who} set XLA_FLAGS {_FLAG}={count} but jax had already "
            f"initialised its backend with "
            f"{jax.local_device_count()} CPU device(s).  A 1-lane "
            "XLA:CPU deadlocks (not fails) inside the host-callback "
            "streaming tests, so refusing to run.  Re-run with the "
            f"flag exported up front, e.g.:\n"
            f"    XLA_FLAGS='{_FLAG}={count}' python -m pytest ...\n"
            "or drop whatever imported jax before conftest.py ran.")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA CUDA card (the port's kernels); "
        "the test skips itself when none is present")


if _FLAG not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " " + _FLAG + "=8").strip()
    _assert_multi_device_view(8, "tests/conftest.py")
