"""``python -m blit_torch`` held against ``python -m blit`` on the CPU:
reduce (a file, a sequence stem with --resume, --product), search,
stream, info, inventory and tune, at tiny shapes, the port with
``--device cpu``.  Each command's JSON line has blit's keys and the same
values where they do not measure time; the products' header bytes are
identical and their f32 data agree to blit's bound (the .hits lines
cell for cell).  Every test runs under a SIGALRM deadline.
"""

import contextlib
import io
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

from blit.__main__ import main as bmain
from blit.testing import build_observation_tree, synth_raw, synth_raw_sequence
from blit_torch.__main__ import main as tmain
from blit_torch.io.sigproc import read_fil, read_fil_header

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 90
TIMED = ("gbps", "hists", "chunk_to_product_p50_s", "chunk_to_product_p99_s",
         "output", "_time_span_s")


@pytest.fixture(autouse=True)
def deadline():
    def expire(signum, frame):
        raise TimeoutError(f"test exceeded its {DEADLINE_S} s deadline")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(DEADLINE_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(list(argv))
    return rc, buf.getvalue()


def _json(text):
    return json.loads(text.strip().splitlines()[-1])


def _both(tmp_path, cmd, args, out_suffix=None, port_extra=("--device", "cpu")):
    """Run one command in both packages; returns (port rep, blit rep,
    port out, blit out)."""
    p = b = None
    pa, ba = list(args), list(args)
    if out_suffix is not None:
        p, b = str(tmp_path / f"p{out_suffix}"), str(tmp_path / f"b{out_suffix}")
        pa += ["-o", p]
        ba += ["-o", b]
    rc, pt = _run(tmain, [cmd, *pa, *port_extra])
    brc, bt = _run(bmain, [cmd, *ba])
    assert rc == brc == 0
    return _json(pt), _json(bt), p, b


def _same_keys_and_values(rep, brep):
    assert set(rep) == set(brep)
    assert {k: v for k, v in rep.items() if k not in TIMED} == \
        {k: v for k, v in brep.items() if k not in TIMED}


def _match_fil(p, b):
    _, off = read_fil_header(p)
    with open(p, "rb") as f, open(b, "rb") as g:
        assert f.read(off) == g.read(off)
    (_, got), (_, want) = read_fil(p), read_fil(b)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-2 * np.abs(want).max())


def test_reduce_file(tmp_path):
    raw = str(tmp_path / "x.raw")
    synth_raw(raw, nblocks=2, obsnchan=2, ntime_per_block=1024, tone_chan=1)
    rep, brep, p, b = _both(tmp_path, "reduce",
                            [raw, "--nfft", "64", "--nint", "2"], ".fil")
    _same_keys_and_values(rep, brep)
    assert rep["nsamps"] > 0
    _match_fil(p, b)


def test_reduce_sequence_stem_resume(tmp_path):
    stem = str(tmp_path / "seq")
    synth_raw_sequence(stem, nfiles=2, blocks_per_file=1, obsnchan=2,
                       ntime_per_block=1024)
    rep, brep, p, b = _both(tmp_path, "reduce",
                            [stem, "--nfft", "64", "--resume"], ".fil")
    _same_keys_and_values(rep, brep)
    _match_fil(p, b)
    assert not os.path.exists(p + ".cursor")


def test_reduce_product_preset(tmp_path):
    raw = str(tmp_path / "p.raw")
    synth_raw(raw, nblocks=2, obsnchan=2, ntime_per_block=4096)
    rep, brep, p, b = _both(tmp_path, "reduce", [raw, "--product", "0001"],
                            ".fil")
    _same_keys_and_values(rep, brep)
    assert rep["nchans"] == 2 * 8
    _match_fil(p, b)


def test_search(tmp_path):
    raw = str(tmp_path / "s.raw")
    synth_raw(raw, nblocks=4, obsnchan=2, ntime_per_block=11 * 256,
              overlap=256, seed=1, tone_chan=1)
    args = [raw, "--nfft", "256", "--nint", "2", "--window-spectra", "8",
            "--snr", "2.0", "--top-k", "4"]
    rep, brep, p, b = _both(tmp_path, "search", args, ".hits")
    _same_keys_and_values(rep, brep)
    assert rep["windows"] >= 2 and rep["hits"] > 0
    with open(p) as f, open(b) as g:
        assert f.readline() == g.readline()
        rows, brows = [json.loads(x) for x in f], [json.loads(x) for x in g]
    cells = ("window", "drift_bins", "chan", "band")
    assert [[r[k] for k in cells] for r in rows] == \
        [[r[k] for k in cells] for r in brows]


@pytest.mark.parametrize("search", [False, True])
def test_stream(tmp_path, search):
    raw = str(tmp_path / "r.raw")
    synth_raw(raw, nblocks=4, obsnchan=2, ntime_per_block=11 * 256,
              overlap=256, seed=1, tone_chan=1)
    args = [raw, "--nfft", "256", "--nint", "2", "--replay-rate", "1000"]
    if search:
        args += ["--search", "--window-spectra", "8", "--snr", "2.0"]
    rep, brep, p, b = _both(tmp_path, "stream", args,
                            ".hits" if search else ".fil")
    _same_keys_and_values(rep, brep)
    assert rep["masked_chunks"] == 0 and rep["stream_chunks"] == 4
    if not search:
        _match_fil(p, b)


def test_info(tmp_path):
    raw = str(tmp_path / "x.raw")
    synth_raw(raw, nblocks=2, obsnchan=2, ntime_per_block=1024)
    fil = str(tmp_path / "x.fil")
    _run(bmain, ["reduce", raw, "-o", fil, "--nfft", "64"])
    for path in (raw, fil):
        rc, pt = _run(tmain, ["info", path])
        brc, bt = _run(bmain, ["info", path])
        assert rc == brc == 0
        assert json.loads(pt) == json.loads(bt)


@pytest.mark.parametrize("sequences", [False, True])
def test_inventory(tmp_path, sequences):
    root = str(tmp_path / "tree")
    build_observation_tree(root)
    args = [root] + (["--sequences"] if sequences else [])
    rc, pt = _run(tmain, ["inventory", *args])
    brc, bt = _run(bmain, ["inventory", *args])
    assert rc == brc == 0
    assert [json.loads(x) for x in pt.splitlines()] == \
        [json.loads(x) for x in bt.splitlines()]


def test_tune_writes_a_profile_the_reducer_loads(tmp_path, monkeypatch):
    monkeypatch.setenv("BLIT_TUNE_DIR", str(tmp_path / "tune"))
    args = ["--nfft", "64", "--nint", "2", "--nchan", "2", "--chunk-frames",
            "4", "--chunks", "4", "--blocks", "2", "--trials", "3"]
    rc, pt = _run(tmain, ["tune", *args, "--device", "cpu"])
    brc, bt = _run(bmain, ["tune", *args])
    assert rc == brc == 0
    rep, brep = _json(pt), _json(bt)
    assert set(rep) == set(brep)
    assert len(rep["trials"]) == len(brep["trials"]) == 3
    assert [{k: t[k] for k in t if k != "score"} for t in rep["trials"]] == \
        [{k: t[k] for k in t if k != "score"} for t in brep["trials"]]
    from blit_torch.pipeline import RawReducer

    red = RawReducer(nfft=64, nint=2, device="cpu")
    prov = red.tuning_provenance()
    assert prov["profile"]["key"] == rep["key"]
    assert set(prov["sources"].values()) == {"profile"}
    assert {k: prov[k] for k in rep["winner"]} == rep["winner"]


def test_default_device_is_the_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    raw = str(tmp_path / "x.raw")
    synth_raw(raw, nblocks=2, obsnchan=2, ntime_per_block=1024)
    out = subprocess.run(
        [sys.executable, "-m", "blit_torch", "reduce", raw, "-o",
         str(tmp_path / "x.fil"), "--nfft", "64"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "CUDA" in out.stderr


def test_only_ported_commands_are_registered():
    """Every command is ported now: each of the operator plane's (the
    last to come) answers ``--help``, and an unknown one is refused."""
    for cmd in ("serve-bench", "top", "ingest-bench", "telemetry",
                "bench-diff", "trace-view", "incidents", "incident",
                "slo-report", "scan", "session", "chaos"):
        with pytest.raises(SystemExit) as e:
            _run(tmain, [cmd, "--help"])
        assert e.value.code == 0
    with pytest.raises(SystemExit) as e:
        _run(tmain, ["no-such-command", "--help"])
    assert e.value.code == 2  # argparse: invalid choice
