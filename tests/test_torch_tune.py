"""The port's tuning profiles and online tuner (blit_torch.tune) held
against blit.tune on the CPU, after tests/test_tune.py.

With the rig identity pinned to the same dict in both packages the
fingerprint keys are equal, and a profile saved by either loads in the
other (its file is asdict(TuningProfile), the same JSON).  tune() takes
the same trials in the same order against the same simulated cost
model, and recommend_from_stages / OnlineTuner recommend the same knobs
from the same stage tables.  The port's reducers take their unset knobs
from the profile and name the source in tuning_provenance as blit's do;
a CPU reducer's lookup leaves CUDA uninitialized.  Every test runs under
a SIGALRM deadline.
"""

import json
import math
import os
import signal
import subprocess
import sys

import pytest

from blit import tune as B
from blit.observability import Timeline as BTimeline
from blit.pipeline import RawReducer as BRawReducer
from blit_torch import tune as T
from blit_torch.observability import Timeline
from blit_torch.pipeline import RawReducer
from blit_torch.search import DedopplerReducer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 60
IDENT = {"host": "blc00", "backend": "cuda",
         "device_kind": "NVIDIA H100 80GB HBM3", "device_count": 1}
SHAPE = dict(nfft=64, nint=2, ntap=4, stokes="I", window="hamming",
             fqav_by=1, dtype="float32", fft_method="auto", nbits=32,
             workload="reduce")


@pytest.fixture(autouse=True)
def deadline():
    def expire(signum, frame):
        raise TimeoutError(f"test exceeded its {DEADLINE_S} s deadline")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(DEADLINE_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


@pytest.fixture
def pinned(monkeypatch, tmp_path):
    """Both packages see the same rig and the same profile dir."""
    monkeypatch.setattr(T, "_rig_identity", lambda device=None: dict(IDENT))
    monkeypatch.setattr(B, "_rig_identity", lambda: dict(IDENT))
    monkeypatch.setenv("BLIT_TUNE_DIR", str(tmp_path))
    monkeypatch.delenv("BLIT_TUNE_ONLINE", raising=False)
    return tmp_path


def cost_model(optimum):
    def measure(knobs):
        pen = abs(math.log2(knobs["chunk_frames"])
                  - math.log2(optimum["chunk_frames"]))
        pen += 0.5 * abs(knobs["prefetch_depth"] - optimum["prefetch_depth"])
        pen += 0.5 * abs(knobs["out_depth"] - optimum["out_depth"])
        return 10.0 / (1.0 + pen)

    return measure


def test_fingerprint_keys_equal_for_a_pinned_identity(pinned):
    for shape in (SHAPE, dict(SHAPE, nbits=8, workload="search"),
                  dict(SHAPE, nfft=1 << 20, nint=1)):
        key, ident = T.rig_fingerprint(**shape)
        bkey, bident = B.rig_fingerprint(**shape)
        assert (key, ident) == (bkey, bident)
    assert T.rig_fingerprint(**SHAPE)[0] != T.rig_fingerprint(
        **dict(SHAPE, nint=4))[0]


@pytest.mark.parametrize("writer", ["port", "blit"])
def test_profiles_cross_load(pinned, writer):
    src, dst = (T, B) if writer == "port" else (B, T)
    key, ident = src.rig_fingerprint(**SHAPE)
    prof = src.TuningProfile(key=key, rig=ident, chunk_frames=16,
                             prefetch_depth=3, out_depth=4, score_gbps=1.5,
                             trials=7, tuned_nchan=64)
    path = src.save_profile(prof)
    assert path == dst._profile_path(key)
    back = dst.lookup(**SHAPE)
    assert back is not None
    assert json.dumps(back.__dict__, sort_keys=True) == \
        json.dumps(prof.__dict__, sort_keys=True)
    assert back.knobs() == {"chunk_frames": 16, "prefetch_depth": 3,
                            "out_depth": 4}
    # A tampered identity no longer hashes to its key: both ignore it.
    with open(path) as f:
        doc = json.load(f)
    doc["rig"]["host"] = "elsewhere"
    with open(path, "w") as f:
        json.dump(doc, f)
    assert T.lookup(**SHAPE) is None and B.lookup(**SHAPE) is None


def test_out_of_range_and_disabled_profiles_ignored(pinned, monkeypatch):
    key, ident = T.rig_fingerprint(**SHAPE)
    T.save_profile(T.TuningProfile(key=key, rig=ident, chunk_frames=16,
                                   prefetch_depth=99, out_depth=2))
    assert T.lookup(**SHAPE) is None and B.lookup(**SHAPE) is None
    T.save_profile(T.TuningProfile(key=key, rig=ident, chunk_frames=16,
                                   prefetch_depth=2, out_depth=2))
    monkeypatch.setenv("BLIT_TUNE", "0")
    assert T.lookup(**SHAPE) is None and B.lookup(**SHAPE) is None


@pytest.mark.parametrize("case", [
    dict(opt={"chunk_frames": 32, "prefetch_depth": 4, "out_depth": 3},
         base={"chunk_frames": 8, "prefetch_depth": 2, "out_depth": 2},
         nint=1, max_trials=40),
    dict(opt={"chunk_frames": 16, "prefetch_depth": 3, "out_depth": 2},
         base={"chunk_frames": 4}, nint=1, max_trials=24),
    dict(opt={"chunk_frames": 48, "prefetch_depth": 2, "out_depth": 5},
         base={"chunk_frames": 7}, nint=3, max_trials=10),
    dict(opt={"chunk_frames": 8, "prefetch_depth": 2, "out_depth": 2},
         base={"chunk_frames": 1 << 14, "prefetch_depth": 99,
               "out_depth": 0}, nint=1, max_trials=12),
])
def test_tune_takes_blit_trials(case):
    kw = dict(base=case["base"], nint=case["nint"],
              max_trials=case["max_trials"])
    got = T.tune(cost_model(case["opt"]), **kw)
    want = B.tune(cost_model(case["opt"]), **kw)
    assert got == want
    assert T.normalize_base(case["base"], nint=case["nint"]) == \
        B.normalize_base(case["base"], nint=case["nint"])


def _stages(*, disp, dev, ingest=0.0, wall=1.0, calls=8):
    return {"dispatch": {"seconds": disp * calls, "calls": calls},
            "device": {"seconds": dev * calls, "calls": calls},
            "ingest": {"seconds": ingest, "calls": calls},
            "stream": {"seconds": wall, "calls": 1}}


LAGGED = {"out.readback_lag_s": {"n": 8, "p50": 0.2, "p99": 0.5},
          "out.chunk_latency_s": {"n": 8, "p50": 0.05, "p99": 0.1}}


@pytest.mark.parametrize("stages,hists", [
    (_stages(disp=0.5, dev=1.0), {}),
    (_stages(disp=0.01, dev=1.0), LAGGED),
    (_stages(disp=0.01, dev=1.0), dict(LAGGED, **{
        "out.readback_lag_s": {"n": 8, "p50": 0.05, "p99": 5.0}})),
    (_stages(disp=0.01, dev=0.1, ingest=4.0, wall=0.0), {}),
    (_stages(disp=0.01, dev=1.0), {}),
])
def test_recommend_from_stages_matches_blit(stages, hists):
    cur = {"chunk_frames": 8, "prefetch_depth": 2, "out_depth": 2}
    got = T.recommend_from_stages(stages, hists, cur, nint=2)
    want = B.recommend_from_stages(stages, hists, cur, nint=2)
    assert (got.knobs, got.reasons) == (want.knobs, want.reasons)


def test_online_tuner_matches_blit_and_persists_opt_in(pinned, monkeypatch):
    cur = {"chunk_frames": 8, "prefetch_depth": 2, "out_depth": 2}
    tuners = []
    for mod, tl in ((T, Timeline()), (B, BTimeline())):
        tuner = mod.OnlineTuner(tl, cur, warmup_chunks=4)
        for i in range(4):
            tl.stages["dispatch"].calls += 1
            tl.stages["dispatch"].seconds += 5.0 if i == 0 else 0.5
            tl.stages["device"].calls += 1
            tl.stages["device"].seconds += 1.0
            tuner.observe_chunk()
            tl.observe("out.readback_lag_s", 5.0 if i == 0 else 0.001)
            tl.observe("out.chunk_latency_s", 0.01)
        assert tuner.converged
        assert tl.gauges["tune.rec_chunk_frames"].last == 16.0
        tuners.append(tuner)
    assert tuners[0].recommendation.knobs == tuners[1].recommendation.knobs
    assert tuners[0].maybe_persist(**SHAPE) is None  # opt-in
    monkeypatch.setenv("BLIT_TUNE_ONLINE", "1")
    path = tuners[0].maybe_persist(tuned_nchan=2, **SHAPE)
    assert path and B.lookup(**SHAPE).source == "online"


def test_reducers_take_profile_knobs_with_provenance(pinned, caplog):
    key, ident = T.rig_fingerprint(**SHAPE)
    T.save_profile(T.TuningProfile(key=key, rig=ident, chunk_frames=16,
                                   prefetch_depth=3, out_depth=4,
                                   tuned_nchan=64))
    red = RawReducer(nfft=64, nint=2, device="cpu")
    bred = BRawReducer(nfft=64, nint=2)
    assert (red.chunk_frames, red.prefetch_depth, red.out_depth) == (16, 3, 4)
    prov, bprov = red.tuning_provenance(), bred.tuning_provenance()
    assert prov == bprov
    assert prov["sources"] == {"chunk_frames": "profile",
                               "prefetch_depth": "profile",
                               "out_depth": "profile"}
    # Explicit knobs win; the rest still come from the profile.
    red = RawReducer(nfft=64, nint=2, chunk_frames=6, device="cpu")
    assert red.tuning_provenance()["sources"] == BRawReducer(
        nfft=64, nint=2, chunk_frames=6).tuning_provenance()["sources"]
    assert red.prefetch_depth == 3
    # A recording of another width warns and says so, as blit does.
    red._note_stream_nchan(2)
    bred._note_stream_nchan(2)
    assert red.tuning_provenance()["profile_nchan_mismatch"] == \
        bred.tuning_provenance()["profile_nchan_mismatch"] == {"tuned": 64,
                                                             "stream": 2}
    # The search takes the inner reducer's knobs and provenance.
    s = DedopplerReducer(nfft=64, nint=2, device="cpu")
    assert (s.prefetch_depth, s.out_depth) == (3, 4)
    assert s.tuning_provenance()["sources"]["out_depth"] == "profile"


def test_reduction_through_a_profile_is_unchanged(pinned, tmp_path):
    from blit_torch.testing import synth_raw

    raw = str(tmp_path / "r.raw")
    synth_raw(raw, nblocks=2, obsnchan=2, ntime_per_block=1000, tone_chan=1)
    a, b = str(tmp_path / "a.fil"), str(tmp_path / "b.fil")
    RawReducer(nfft=64, nint=2, chunk_frames=4, prefetch_depth=2,
               out_depth=2, device="cpu").reduce_to_file(raw, a)
    key, ident = T.rig_fingerprint(**SHAPE)
    T.save_profile(T.TuningProfile(key=key, rig=ident, chunk_frames=8,
                                   prefetch_depth=3, out_depth=4))
    red = RawReducer(nfft=64, nint=2, device="cpu")
    assert red.chunk_frames == 8
    red.reduce_to_file(raw, b)
    with open(a, "rb") as f, open(b, "rb") as g:
        assert f.read() == g.read()


def test_cpu_lookup_leaves_cuda_uninitialized(tmp_path):
    code = (
        "import json, torch\n"
        "from blit_torch import tune\n"
        "from blit_torch.pipeline import RawReducer\n"
        "red = RawReducer(nfft=64, nint=2, device='cpu')\n"
        "key, ident = tune.rig_fingerprint(nfft=64, nint=2, device='cpu')\n"
        "print(json.dumps({'init': torch.cuda.is_initialized(), "
        "'ident': ident, 'src': red.tuning_provenance()['sources']}))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO, BLIT_TUNE_DIR=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    doc = json.loads(out.stdout.strip().splitlines()[-1])
    assert doc["init"] is False
    assert doc["ident"]["backend"] == "cpu" and doc["ident"]["device_count"] == 1
    assert doc["src"]["chunk_frames"] == "default"
