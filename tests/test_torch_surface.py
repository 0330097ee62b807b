"""The port's import surface: blit_torch imports torch and numpy, never
jax, never a module of blit, and builds no kernel when imported."""

import ast
import json
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import blit_torch
from blit_torch.pipeline import RawReducer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "blit_torch")


def _all_modules():
    names = ["blit_torch"]
    for info in pkgutil.walk_packages([PKG], prefix="blit_torch."):
        names.append(info.name)
    return names


def _listing(path):
    return sorted(os.listdir(path)) if os.path.isdir(path) else []


def test_import_pulls_in_no_jax_blit_triton_or_cpp_extension():
    mods = _all_modules()
    assert {"blit_torch.ops.pfb", "blit_torch.ops.detect", "blit_torch.pipeline",
            "blit_torch.io.guppi", "blit_torch.kernels",
            "blit_torch.search.dedoppler", "blit_torch.ops.dedoppler",
            "blit_torch.io.hits", "blit_torch.ops.beamform",
            "blit_torch.ops.xengine", "blit_torch.parallel",
            "blit_torch.parallel.antenna", "blit_torch.parallel.beamform",
            "blit_torch.parallel.correlator", "blit_torch.hostmem",
            "blit_torch.outplane", "blit_torch.ops.narrow", "blit_torch.faults",
            "blit_torch.integrity", "blit_torch.io.native", "blit_torch.io.bshuf",
            "blit_torch.io.sigproc", "blit_torch.config",
            "blit_torch.testing", "blit_torch.naming", "blit_torch.inventory",
            "blit_torch.workers", "blit_torch.gbt", "blit_torch.agent",
            "blit_torch.parallel.pool", "blit_torch.parallel.remote",
            "blit_torch.ops.stats", "blit_torch.ops.despike",
            "blit_torch.io.fbh5", "blit_torch.tune", "blit_torch.monitor",
            "blit_torch.__main__", "blit_torch.stream",
            "blit_torch.stream.source", "blit_torch.stream.packet",
            "blit_torch.stream.cursor", "blit_torch.stream.plane",
            "blit_torch.stream.session", "blit_torch.parallel.mesh",
            "blit_torch.parallel.multihost", "blit_torch.parallel.scan",
            "blit_torch.parallel.sharded", "blit_torch.recover",
            "blit_torch.history", "blit_torch.serve",
            "blit_torch.serve.cache", "blit_torch.serve.catalog",
            "blit_torch.serve.elastic", "blit_torch.serve.fleet",
            "blit_torch.serve.http", "blit_torch.serve.ring",
            "blit_torch.serve.scheduler",
            "blit_torch.serve.service"} <= set(mods)
    # h5py loads only when an .h5 file is opened: no module imports it,
    # blit_torch.io.fbh5 included.
    plain = mods
    code = (
        "import importlib, json, sys\n"
        f"for m in {plain!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'jaxlib', 'triton', 'h5py')) or m == 'blit' or "
        "m.startswith('blit.') or m.startswith('torch.utils.cpp_extension'))\n"
        "print(json.dumps(bad))\n"
    )
    builds = [os.path.join(PKG, "native", "build"),
              os.path.join(PKG, "kernels", "build")]
    before = [_listing(d) for d in builds]
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    # Importing builds nothing: no g++ or nvcc output appeared.
    assert [_listing(d) for d in builds] == before


def test_workers_and_gbt_import_no_h5py_jax_or_blit(tmp_path):
    # A GPU host may lack h5py: the workers' format dispatch and
    # the .fil path must run without it.
    code = (
        "import json, sys\n"
        "import blit_torch.workers, blit_torch.gbt\n"
        "from blit_torch import testing, workers\n"
        f"p = {str(tmp_path / 'x.fil')!r}\n"
        "testing.synth_fil(p, nsamps=4, nchans=64)\n"
        "from blit_torch.io.fbh5 import is_hdf5\n"
        "assert not is_hdf5(p)\n"
        "workers.get_header(p); workers.get_data(p, fqav_by=4)\n"
        "workers.get_kurtosis(p, device='cpu')\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'blit', 'h5py') or "
        "m.startswith(('jax.', 'jaxlib', 'h5py.', 'blit.')))\n"
        "print(json.dumps(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_source_has_no_jax_or_blit_imports():
    offenders = []
    for root, _, files in os.walk(PKG):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(root, fn)
            with open(path) as f:
                tree = ast.parse(f.read(), path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom):
                    names = [node.module or ""]
                else:
                    continue
                for n in names:
                    top = n.split(".")[0]
                    if top in ("jax", "jaxlib", "blit", "triton"):
                        offenders.append(f"{path}: {n}")
    assert offenders == []


def test_live_plane_modules_import_no_jax_blit_triton_or_cpp_extension():
    # The live plane and the command line, each imported alone in a fresh
    # process: no jax, no blit, no triton, no cpp_extension, and CUDA
    # left uninitialized (the publisher and the tuner touch it only for
    # a reducer on the card).
    for mod in ("blit_torch.stream", "blit_torch.tune", "blit_torch.monitor",
                "blit_torch.__main__"):
        code = (
            "import importlib, json, sys, torch\n"
            f"importlib.import_module({mod!r})\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'jaxlib', 'triton')) or m == 'blit' or "
            "m.startswith('blit.') or m.startswith('torch.utils.cpp_extension'))\n"
            "print(json.dumps([bad, torch.cuda.is_initialized()]))\n"
        )
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                             env=dict(os.environ, PYTHONPATH=REPO),
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr
        assert json.loads(out.stdout.strip().splitlines()[-1]) == [[], False], mod


@pytest.mark.parametrize("mod", ["blit_torch.parallel.mesh",
                                 "blit_torch.parallel.multihost",
                                 "blit_torch.parallel.scan",
                                 "blit_torch.parallel.sharded",
                                 "blit_torch.recover",
                                 "blit_torch.stream.session"])
def test_mesh_and_recovery_modules_import_alone_and_start_no_group(mod):
    # Each imported alone in a fresh process: no jax, no blit, no
    # triton, no cpp_extension, no process group, CUDA untouched.
    code = (
        "import importlib, json, sys, torch\n"
        "import torch.distributed as dist\n"
        f"importlib.import_module({mod!r})\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'jaxlib', 'triton')) or m == 'blit' or "
        "m.startswith('blit.') or m.startswith('torch.utils.cpp_extension'))\n"
        "print(json.dumps([bad, dist.is_available() and dist.is_initialized(), "
        "torch.cuda.is_initialized()]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [[], False, False]


@pytest.mark.parametrize("mod", ["blit_torch.serve",
                                 "blit_torch.serve.fleet",
                                 "blit_torch.serve.http",
                                 "blit_torch.serve.elastic",
                                 "blit_torch.serve.catalog",
                                 "blit_torch.history"])
def test_serve_modules_import_alone_without_jax_blit_or_cuda(mod):
    # Each imported alone in a fresh process: no jax, no blit, no
    # triton, no cpp_extension, CUDA untouched (a front door runs on a
    # host without a card; a service takes the card when it is built).
    code = (
        "import importlib, json, sys, torch\n"
        f"importlib.import_module({mod!r})\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'jaxlib', 'triton')) or m == 'blit' or "
        "m.startswith('blit.') or m.startswith('torch.utils.cpp_extension'))\n"
        "print(json.dumps([bad, torch.cuda.is_initialized()]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [[], False]


def test_serve_all_equals_blits():
    pytest.importorskip("jax")
    import blit.serve as bserve

    import blit_torch.serve as tserve

    assert tserve.__all__ == bserve.__all__
    for name in tserve.__all__:
        assert hasattr(tserve, name)


def test_serve_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    from blit_torch import integrity
    from blit_torch.serve import ProductRequest, ProductService

    with pytest.raises(RuntimeError, match="device='cpu'"):
        ProductService()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ProductRequest(raw="a.raw", nfft=64).reducer()
    # Verification alone needs no device.
    assert integrity.fsck(str(tmp_path))["clean"]


def test_mesh_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    from blit_torch.parallel import multihost, scan
    from blit_torch.parallel.mesh import make_mesh
    from blit_torch.recover import ScanSupervisor

    with pytest.raises(RuntimeError, match="device='cpu'"):
        scan.load_scan_mesh([["a.raw"]], nfft=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh(1, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        multihost.local_devices()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        multihost.init_multihost("127.0.0.1:1", num_processes=1, process_id=0)
    assert not multihost.in_pod()
    assert make_mesh(1, 2, devices=["cpu", "cpu"]).nprocs() == 1
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ScanSupervisor([["a.raw"]], out_dir=str(tmp_path), nfft=64)


def test_default_device_without_gpu_raises_clear_error():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RawReducer(nfft=1 << 20)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        blit_torch.DedopplerReducer(nfft=1024)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        blit_torch.channelize(torch.zeros((1, 5 * 64, 2, 2), dtype=torch.int8),
                              torch.zeros((4, 64)), nfft=64)


def test_array_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    from blit_torch.parallel import antenna, beamform, correlator

    v = torch.zeros((2, 1, 64, 2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        beamform.beamform(v, torch.zeros((3, 2, 1)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        beamform.delay_weights_planar(torch.zeros((3, 2)), torch.zeros(1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        correlator.correlate(v, torch.zeros((4, 16)), nfft=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        antenna.load_antennas(["a.raw"])


@pytest.mark.parametrize("nfft,npol", [(1024, 1), (1 << 19, 1), (1 << 20, 1)])
def test_cuda_plan_refuses_unported_shapes_before_any_copy(monkeypatch, nfft, npol):
    # The CUDA plan check runs before any tensor moves to the device, so
    # the refusal is exercised here by resolving the device to CUDA: an
    # explicit two-pol front on one-pol input raises, as blit's does.
    from blit_torch.ops import channelize as tch

    monkeypatch.setattr(tch, "resolve_device", lambda d: torch.device("cuda"))
    v = torch.zeros((1, 5 * nfft, npol, 2), dtype=torch.int8)
    for front in ("pallas", "fused1"):
        with pytest.raises(ValueError, match="pfb_kernel.*npol=2"):
            tch.channelize(v, torch.zeros((4, nfft)), nfft=nfft,
                           pfb_kernel=front)


@pytest.mark.parametrize("nfft,plan", [
    (8, ("pallas", "dft_last", "torch")),
    (1024, ("pallas", "dft_last", "torch")),
    (4096, ("pallas", "dft_last", "torch")),
    (1 << 13, ("fused1", "dft_last", "torch")),
    (1 << 19, ("fused1", "dft_last", "torch")),
    (1 << 20, ("fused1", "tail2_detect", "tail2_detect")),
    (1 << 21, ("fused1", "dft_tail2", "torch")),
    (1 << 23, ("fused1", "dft_tail2", "torch")),
    (1 << 24, ("fused1", "dft_stage+dft_last", "torch")),
    (6144, ("fused1", "dft_last", "torch")),
], ids=lambda x: str(x))
def test_cuda_plan_takes_every_two_pol_nfft(nfft, plan):
    # Every nfft that default_factors splits resolves to a route of
    # Hopper kernels for two-pol input; none to a plain twin.
    from blit_torch.ops import channelize as tch

    route, factors, rec = tch._resolve_plan(nfft, 2, "I")
    assert route in ("tail2_detect", "fused1_tail2", "fused1", "front")
    assert (rec["pfb_kernel"], rec["tail_kernel"], rec["detect_kernel"]) == plan
    # An nfft default_factors cannot split takes torch.fft under "auto"
    # (blit's off-TPU resolution); an explicit "matmul" still raises.
    route, _, rec = tch._resolve_plan(2 * 4099, 2, "I")
    assert (route, rec["fft_method"], rec["tail_kernel"]) == (
        "front", "four_step", "torch")
    with pytest.raises(NotImplementedError, match="factorization"):
        tch._resolve_plan(2 * 4099, 2, "I", fft_method="matmul")
