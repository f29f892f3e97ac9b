import os

# The suite keeps BOTH backends live:
#   - the CPU platform gets 8 virtual devices so multi-chip sharding paths are
#     exercised without TPU hardware, and is the DEFAULT device so the bulk of
#     the suite is fast and deterministic;
#   - the accelerator platform (when present) stays initialized and reachable,
#     so TPU-capable tests (Pallas kernel parity, the gated full pipeline) run
#     for real instead of skipping.
# The gated full-pipeline test (OMVS_RUN_PIPELINE_TEST=1) keeps the native
# accelerator as the default device to exercise the production TPU path.
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if not os.environ.get("OMVS_RUN_PIPELINE_TEST"):
    try:
        jax.config.update(
            "jax_default_device", jax.local_devices(backend="cpu")[0]
        )
    except RuntimeError:  # pragma: no cover - cpu platform always exists
        pass

# Interpret-mode kernel tests verify LOGIC, not perf, and the round-4
# production defaults (25-texel grid chunks + hoisted source band) are ~25x
# slower to EMULATE than the minimal config — pin the small config for the
# whole suite UNCONDITIONALLY (round-5: previously only when no accelerator
# was present, which made the suite impractically slow exactly on the TPU
# host).  The TPU-gated hardware parity tests restore the SHIPPING config
# explicitly via the `shipping_kernel_config` fixture below, so what users
# run on hardware stays covered by exactly those tests.
# (the gated full-pipeline run IS the production path — keep its defaults)
if not os.environ.get("OMVS_RUN_PIPELINE_TEST"):
    os.environ.setdefault("OMVS_TEXEL_CHUNK", "5")
    os.environ.setdefault("OMVS_HOIST", "0")

import pytest  # noqa: E402

REFERENCE_DATA = "/root/reference/apps/Tests/data"


def pytest_configure(config):
    # tests that need a CUDA card decide inside a fixture and skip on the
    # CPU; on the card: python3 -m pytest --noconftest <file> (no JAX there)
    config.addinivalue_line("markers", "card: needs a CUDA card; skips on the CPU")


def tpu_devices():
    """Accelerator devices if any non-CPU platform is initialized, else []."""
    try:
        return [d for d in jax.devices() if d.platform != "cpu"]
    except RuntimeError:
        return []


@pytest.fixture
def shipping_kernel_config():
    """Temporarily restore the SHIPPING kernel config (TEXEL_CHUNK=25 +
    hoisted source band, the round-4 battery winner) for hardware parity
    tests, overriding the suite-wide minimal-config pin above.

    TEXEL_CHUNK is read at trace time inside the jitted kernels (a module
    global, not a static arg), so the jit caches must be cleared on BOTH
    transitions — the round-3 stale-trace trap."""
    from openmvs_tpu.ops import pm_kernel

    def _clear():
        pm_kernel._score_view_pallas._clear_cache()
        pm_kernel._score_view_geom_pallas._clear_cache()
        pm_kernel.geom_term_pallas._clear_cache()

    old = (pm_kernel.TEXEL_CHUNK, pm_kernel.HOIST)
    pm_kernel.TEXEL_CHUNK, pm_kernel.HOIST = 25, True
    _clear()
    try:
        yield
    finally:
        pm_kernel.TEXEL_CHUNK, pm_kernel.HOIST = old
        _clear()


@pytest.fixture(scope="session")
def test_scene_path():
    path = os.path.join(REFERENCE_DATA, "scene.mvs")
    if not os.path.exists(path):
        pytest.skip("bundled test scene not available")
    return path
