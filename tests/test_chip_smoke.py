"""chip_smoke.py's phase functions at tiny sizes on the CPU, called directly
(the full-size run needs the card), plus the device check it shares with
bench.py. Each kernel check runs its function twice on the CPU here, so it
exercises the comparison and its gates, not the GPU's numbers."""
import json

import numpy as np
import pytest

import chip_smoke as S


def test_check_hamming_tiny():
    assert all(S.check_hamming(((256, 256), (300, 130))).values())


def test_check_extract_tiny():
    r = S.check_extract(height=120, width=160, n_features=200, n_levels=4)
    assert r["n_device"] == r["n_cpu"] > 0
    assert r["frac_matched"] == 1.0 and r["frac_desc_equal"] == 1.0


def test_check_pose_opt_tiny():
    r = S.check_pose_opt(n_obs=128)
    assert r["max_abs_dT"] <= S.POSE_TOL
    # the 4x10 LM reaches the true pose through noise and outliers
    assert r["max_abs_err_vs_truth"] < 1e-2


def test_check_ba_tiny():
    r = S.check_ba(C=4, P=128, E=512)
    assert r["rel_diff"] <= S.BA_COST_REL and r["inliers_device"] > 0


def test_check_pgo_tiny():
    assert S.check_pgo(K=32)["max_abs_dt"] <= S.PGO_T_TOL


def test_check_two_view_tiny():
    res = S.check_two_view(n=256)
    homography = [r["homography"][0] for r in res.values()]
    assert homography == [False, True]   # general scene -> F, planar -> H


def test_check_pnp_tiny():
    r = S.check_pnp(n=256)
    assert r["inliers"][0] == r["inliers"][1] > 128
    assert r["err_vs_truth"] < 1e-3


def _system_row(**kw):
    row = dict(tracked=150, n_trackable=159, n_init=21, n=180,
               ate_m=0.005, keyframes=4)
    row.update(kw)
    return row


def test_system_gates_pass():
    S.check_system_gates("mono", _system_row())


@pytest.mark.parametrize("bad", [
    dict(tracked=100),                 # < 90% of post-init frames
    dict(n_init=60, n_trackable=120),  # init later than 30% of frames
    dict(ate_m=0.021),                 # over the mono ATE limit
    dict(ate_m=float("nan")),          # no trajectory to evaluate
    dict(keyframes=1),                 # mapping never ran
], ids=["tracked", "init", "ate", "nan", "keyframes"])
def test_system_gates_fail(bad):
    with pytest.raises(AssertionError):
        S.check_system_gates("mono", _system_row(**bad))


def test_loop_gates():
    good = dict(n=240, tracked=238, loops=1, gba_applied=1, ate_m=0.011)
    S.check_loop_gates(good)
    for bad in (dict(loops=0), dict(gba_applied=0), dict(ate_m=0.031),
                dict(tracked=230)):
        with pytest.raises(AssertionError):
            S.check_loop_gates(dict(good, **bad))


def test_main_refuses_cpu(capsys):
    """Without a GPU the smoke exits non-zero and prints no result."""
    assert S.main([]) != 0
    out = capsys.readouterr().out
    assert not any(line.startswith("{") for line in out.splitlines())


def test_bench_refuses_cpu(capsys):
    import bench
    assert bench.main() != 0
    assert "GPU is required" in capsys.readouterr().err


@pytest.mark.gpu
def test_kernels_on_gpu(gpu):
    """The kernels phase at real widths, on the card."""
    S.phase_kernels()


@pytest.fixture
def gpu():
    import jax
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs this on the card")
    return jax.devices()[0]


def test_result_line_format(monkeypatch, capsys):
    """The last stdout line is the JSON object the card run reports."""
    monkeypatch.setattr(S, "phase_device", lambda n: (
        {"platform": "gpu", "kind": "Fake GPU", "count": n}, "Fake, 1 W"))
    monkeypatch.setattr(S, "phase_kernels", lambda: {})
    monkeypatch.setattr(S, "phase_system", lambda card: {})
    monkeypatch.setattr(S, "phase_loop", lambda card: {})
    assert S.main([]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {"ok": True, "device": {
        "platform": "gpu", "kind": "Fake GPU", "count": 1}}


def test_four_cards_runs_only_its_phase(monkeypatch, capsys):
    ran = []
    monkeypatch.setattr(S, "phase_device", lambda n: (
        {"platform": "gpu", "kind": "Fake GPU", "count": n}, "Fake, 1 W"))
    for name in ("phase_kernels", "phase_system", "phase_loop"):
        monkeypatch.setattr(S, name, lambda *a, _n=name: ran.append(_n))
    monkeypatch.setattr(S, "phase_four_cards",
                        lambda card, n: ran.append("phase_four_cards"))
    assert S.main(["--four-cards"]) == 0
    assert ran == ["phase_four_cards"]
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last)["device"]["count"] == 4


def test_failed_phase_stops_the_run(monkeypatch, capsys):
    monkeypatch.setattr(S, "phase_device", lambda n: (
        {"platform": "gpu", "kind": "Fake GPU", "count": n}, "Fake, 1 W"))

    def failing():
        raise AssertionError("gate")
    monkeypatch.setattr(S, "phase_kernels", failing)
    monkeypatch.setattr(S, "phase_system",
                        lambda card: pytest.fail("ran past a failed phase"))
    with pytest.raises(AssertionError):
        S.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_hamming_reference_chunks_match_direct():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2 ** 32, (300, 8), dtype=np.uint32)
    b = rng.integers(0, 2 ** 32, (5, 8), dtype=np.uint32)
    direct = np.array([[sum(bin(int(x) ^ int(y)).count("1")
                            for x, y in zip(ra, rb)) for rb in b] for ra in a])
    np.testing.assert_array_equal(S.hamming_reference(a, b), direct)
