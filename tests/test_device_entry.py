"""Device entry points: the compile-cache location, the chip smoke
script's and the timing tools' refusal without a GPU, the per-frame
decode route record, and
the GOP-parallel device path's error propagation."""
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")


@pytest.fixture
def restore_cache_dir():
    import jax
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_follows_env(monkeypatch, tmp_path, restore_cache_dir):
    import jax
    from libde265_tpu.compile_cache import enable_compile_cache
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_compile_cache_defaults_to_repo(monkeypatch, restore_cache_dir):
    import jax
    from libde265_tpu.compile_cache import enable_compile_cache
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = enable_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def _run_smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_gpu():
    r = _run_smoke(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr


@pytest.mark.parametrize("cmd", [
    ["bench.py"],
    ["tools/profile_frame_stages.py"],
    ["tools/bench_gop_device.py"],
    ["tools/bench_e2e.py", "tests/data/p_mv.bin", "device"],
])
def test_timing_tools_fail_without_gpu(cmd):
    """No timing entry point reports device numbers from the CPU."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO, cmd[0])]
                       + cmd[1:], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0
    assert "GPU" in r.stderr and not r.stdout.strip()


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    script = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), script)
    r = _run_smoke(str(tmp_path), str(script))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


@pytest.mark.parametrize("name,routes", [
    ("p_mv", {"fused"}),                        # fused frame program
    ("rxt_cqo", {"hybrid"}),                    # TU-level chroma QP offsets
    ("rxt_ccp_444", {"numpy"}),                 # cross-component prediction
    ("rxt_erdpcm", {"fused", "hybrid"}),        # explicit RDPCM from frame 1
])
def test_decode_route_recorded(name, routes):
    """Every picture of the device backend carries the route it took, and
    the decoder counts routes per frame."""
    from libde265_tpu.api import decode_stream_native, parse_stream_native
    from libde265_tpu.device_stream import DeviceStreamDecoder
    with open(os.path.join(DATA, name + ".bin"), "rb") as f:
        data = f.read()
    pics = decode_stream_native(data, backend="device")
    assert {p.route for p in pics} == routes
    plans = parse_stream_native(data)
    dec = DeviceStreamDecoder(plans, plans[0].sps)
    dec.decode_all()
    counts = dec.route_counts()
    assert set(counts) == routes and sum(counts.values()) == len(plans)
    host = decode_stream_native(data)
    assert all(p.route is None for p in host)


def test_gop_parallel_device_errors_propagate(monkeypatch):
    """backend="device" never falls back to host workers: a device-path
    error reaches the caller."""
    from libde265_tpu.parallel import gop_parallel

    def boom(stream, mesh=None):
        raise ValueError("device path failed")
    monkeypatch.setattr(gop_parallel, "decode_gop_device", boom)
    with pytest.raises(ValueError, match="device path failed"):
        gop_parallel.decode_gop_parallel(b"", backend="device")


def test_gop_parallel_unknown_backend():
    from libde265_tpu.parallel.gop_parallel import decode_gop_parallel
    with pytest.raises(ValueError, match="unknown backend"):
        decode_gop_parallel(b"", backend="bogus")
