"""Distributed BA over the virtual device mesh: correctness + sharding."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from orbslam2_tpu.ops import ba as BA
from orbslam2_tpu.parallel.dist_ba import make_mesh, dist_ba_solve, shard_problem


def synth_problem(seed=0, C=6, P=256, E=2048, noise=0.4):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-2, 2, P), rng.uniform(-1.5, 1.5, P),
                    rng.uniform(4, 9, P)], -1).astype(np.float32)
    cams = np.stack([
        np.hstack([np.eye(3), np.array([[0.25 * i], [0.0], [0.0]])]).astype(np.float32)
        for i in range(C)])
    fx = fy = 500.0
    cx, cy = 320.0, 240.0
    e_cam = rng.integers(0, C, E).astype(np.int32)
    e_pt = rng.integers(0, P, E).astype(np.int32)
    pc = np.einsum("eij,ej->ei", cams[e_cam, :, :3], pts[e_pt]) + cams[e_cam, :, 3]
    uv = np.stack([fx * pc[:, 0] / pc[:, 2] + cx,
                   fy * pc[:, 1] / pc[:, 2] + cy, np.zeros(E)], -1)
    uv[:, :2] += rng.normal(0, noise, (E, 2))
    cam_pert = cams.copy()
    cam_pert[1:, :, 3] += rng.normal(0, 0.02, (C - 1, 3))
    return BA.BAProblem(
        cam_T=jnp.asarray(cam_pert),
        cam_fixed=jnp.asarray(np.arange(C) < 1),
        cam_valid=jnp.ones(C, bool),
        pts=jnp.asarray(pts + rng.normal(0, 0.03, (P, 3)).astype(np.float32)),
        pt_valid=jnp.ones(P, bool),
        e_cam=jnp.asarray(e_cam), e_pt=jnp.asarray(e_pt),
        e_obs=jnp.asarray(uv.astype(np.float32)),
        e_stereo=jnp.zeros(E, bool),
        e_info=jnp.ones(E, jnp.float32),
        e_valid=jnp.ones(E, bool),
    ), cams, (fx, fy, cx, cy)


class TestDistributedBA:
    def test_sharded_matches_single_device(self):
        prob, cams_gt, (fx, fy, cx, cy) = synth_problem()
        ref = BA.ba_solve(prob, fx, fy, cx, cy, 0.0)
        mesh = make_mesh(8)
        out = dist_ba_solve(prob, mesh, fx, fy, cx, cy, 0.0)
        # identical math (collectives preserve segment-sum results)
        np.testing.assert_allclose(np.asarray(ref.cam_T), np.asarray(out.cam_T),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(float(ref.cost), float(out.cost), rtol=1e-3)

    def test_sharded_solution_quality(self):
        prob, cams_gt, (fx, fy, cx, cy) = synth_problem(seed=3)
        mesh = make_mesh(4)
        out = dist_ba_solve(prob, mesh, fx, fy, cx, cy, 0.0)
        err = np.abs(np.asarray(out.cam_T) - cams_gt).max()
        # 0.4px obs noise over ~340 edges/cam -> ~1cm pose noise floor
        assert err < 0.02, err

    def test_edge_arrays_actually_sharded(self):
        prob, _, _ = synth_problem()
        mesh = make_mesh(8)
        sp = shard_problem(prob, mesh)
        shard_count = len(sp.e_obs.sharding.device_set)
        assert shard_count == 8
        # cams replicated
        assert len(sp.cam_T.sharding.device_set) == 8
        assert sp.cam_T.sharding.is_fully_replicated
        assert not sp.e_obs.sharding.is_fully_replicated


class TestLargeScaleBA:
    def test_global_ba_scale(self):
        """KITTI-scale global BA smoke: 128 cameras, 8k points, 64k edges
        through the big buckets (finite result, cost below start)."""
        prob, cams_gt, (fx, fy, cx, cy) = synth_problem(
            seed=7, C=128, P=8192, E=65536, noise=0.5)
        res = BA.ba_solve(prob, fx, fy, cx, cy, 0.0, iters1=3, iters2=3)
        assert np.isfinite(float(res.cost))
        assert bool(jnp.isfinite(res.cam_T).all())
        err = np.abs(np.asarray(res.cam_T) - cams_gt).max()
        assert err < 0.05, err

    def test_point_blocks_sharded_and_collectives_lowered(self):
        """SURVEY §2.4: point blocks (Hpp, back-substitution) shard across
        the mesh — and the lowered program really communicates (contains
        collective ops) instead of silently replicating."""
        from orbslam2_tpu.parallel.dist_ba import lowered_collectives
        prob, _, (fx, fy, cx, cy) = synth_problem()
        mesh = make_mesh(8)
        sp = shard_problem(prob, mesh)
        assert not sp.pts.sharding.is_fully_replicated
        assert len(sp.pts.sharding.device_set) == 8
        colls = lowered_collectives(prob, mesh, fx, fy, cx, cy, 0.0)
        assert colls, "no collectives in the sharded BA program"


class TestDistPGO:
    """Sharded pose-graph optimizer (parallel/dist_pgo.py): the loop-
    closure solver's edge set sharded over the virtual mesh, vertices
    replicated — sharded == single-device parity + collectives present
    (VERDICT r3 item 10; reference counterpart src/Optimizer.cpp:944)."""

    def _problem(self):
        import sys
        sys.path.insert(0, "/root/repo")
        from __graft_entry__ import _make_pgo_problem
        return tuple(jnp.asarray(a) for a in _make_pgo_problem(K=64))

    def test_sharded_matches_single_device(self):
        from orbslam2_tpu.parallel.dist_pgo import dist_pose_graph
        prob = self._problem()
        sv1, R1, t1, _ = dist_pose_graph(make_mesh(1), *prob, iters=5)
        svN, RN, tN, _ = dist_pose_graph(make_mesh(len(jax.devices())),
                                         *prob, iters=5)
        assert np.isfinite(np.asarray(tN)).all()
        np.testing.assert_allclose(np.asarray(tN), np.asarray(t1), atol=2e-2)
        np.testing.assert_allclose(np.asarray(svN), np.asarray(sv1),
                                   atol=1e-3)

    def test_collectives_lowered(self):
        from orbslam2_tpu.parallel.dist_pgo import lowered_collectives_pgo
        prob = self._problem()
        colls = lowered_collectives_pgo(make_mesh(len(jax.devices())), *prob)
        assert colls, "sharded PGO must lower collectives"

    def test_reduces_loop_drift(self):
        from orbslam2_tpu.parallel.dist_pgo import dist_pose_graph
        import sys
        sys.path.insert(0, "/root/repo")
        from __graft_entry__ import _make_pgo_problem
        raw = _make_pgo_problem(K=64)
        prob = tuple(jnp.asarray(a) for a in raw)
        svN, RN, tN, costs = dist_pose_graph(
            make_mesh(len(jax.devices())), *prob, iters=10)
        costs = np.asarray(costs)
        assert costs[-1] < 0.2 * costs[0], \
            f"PGO failed to reduce residual: {costs[0]} -> {costs[-1]}"


def test_dryrun_multichip_small():
    """The parity checks `chip_smoke.py --four-cards` runs on four cards,
    here on four of the virtual CPU devices at a reduced scale."""
    from __graft_entry__ import dryrun_multichip
    out = dryrun_multichip(4, crossover=(16, 1024, 8192),
                           kitti=(16, 1024, 8192), pgo_k=64)
    assert out["devices"] == 4 and out["collectives"]
    assert 0.95 < out["cost_ratio"] < 1.05
    assert out["pgo_max_dt"] < 1e-3
    assert out["crossover_step_s_1"] > 0 and out["crossover_step_s_n"] > 0


def test_ensure_n_devices_refuses_too_few():
    from __graft_entry__ import _ensure_n_devices
    _ensure_n_devices(len(jax.devices()))
    with pytest.raises(RuntimeError, match="needed for the mesh"):
        _ensure_n_devices(len(jax.devices()) + 1)
