import jax
import jax.numpy as jnp
import numpy as np
import pytest

from orbslam2_tpu.config import OrbParams
from orbslam2_tpu.ops import features as F
from orbslam2_tpu.ops import matching as M


def synth_texture(h=240, w=320, seed=0):
    """Smooth random texture with plenty of corners."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (h // 8, w // 8)).astype(np.float32)
    img = np.kron(img, np.ones((8, 8), np.float32))  # blocky -> corners at block edges
    img += rng.normal(0, 2.0, (h, w)).astype(np.float32)
    return np.clip(img, 0, 255)


class TestFast:
    def test_square_corners_detected(self):
        img = np.zeros((64, 64), np.float32)
        img[24:40, 24:40] = 255.0
        rh, _ = F.fast_response(jnp.asarray(img), 20.0, 7.0)
        rh = np.asarray(rh)
        # corner responses near the 4 square corners; none in flat regions
        assert rh[10, 10] == 0 and rh[32, 32] == 0
        for cy, cx in [(24, 24), (24, 39), (39, 24), (39, 39)]:
            assert rh[cy - 2: cy + 3, cx - 2: cx + 3].max() > 0, (cy, cx)

    def test_no_corners_on_flat(self):
        img = jnp.full((64, 64), 128.0)
        rh, rl = F.fast_response(img, 20.0, 7.0)
        assert float(jnp.max(rh)) == 0.0 and float(jnp.max(rl)) == 0.0

    def test_cv2_fast_parity(self):
        """Raw FAST-9/16 detection parity vs OpenCV (pre-NMS; our corner score
        differs by design, so NMS survivors may differ)."""
        cv2 = pytest.importorskip("cv2")
        img = synth_texture()
        det = cv2.FastFeatureDetector_create(threshold=20, nonmaxSuppression=False)
        kps = det.detect(img.astype(np.uint8), None)
        cv_mask = np.zeros(img.shape, bool)
        for k in kps:
            cv_mask[int(round(k.pt[1])), int(round(k.pt[0]))] = True
        rh, _ = F.fast_response(jnp.asarray(img), 20.0, 7.0)
        ours = np.asarray(rh) > 0
        inner = np.zeros(img.shape, bool)
        inner[4:-4, 4:-4] = True
        cv_i, ours_i = cv_mask & inner, ours & inner
        recall = (cv_i & ours_i).sum() / max(cv_i.sum(), 1)
        precision = (cv_i & ours_i).sum() / max(ours_i.sum(), 1)
        assert recall > 0.99, recall
        assert precision > 0.98, precision


class TestSelection:
    def test_budget_and_validity(self):
        img = jnp.asarray(synth_texture())
        rh, rl = F.fast_response(img, 20.0, 7.0)
        xs, ys, resp, valid = F.select_keypoints(rh, rl, 200, 32, F.EDGE_BORDER)
        assert xs.shape == (200,)
        v = np.asarray(valid)
        assert v.sum() > 50
        # all valid picks respect the border
        xs, ys = np.asarray(xs)[v], np.asarray(ys)[v]
        assert (xs >= F.EDGE_BORDER).all() and (ys >= F.EDGE_BORDER).all()

    def test_spatial_uniformity(self):
        # one very strong corner cluster + weak corners elsewhere: selection
        # must still cover multiple cells
        img = jnp.asarray(synth_texture(seed=3))
        rh, rl = F.fast_response(img, 20.0, 7.0)
        xs, ys, resp, valid = F.select_keypoints(rh, rl, 100, 32, F.EDGE_BORDER)
        v = np.asarray(valid)
        cells = {(int(y) // 32, int(x) // 32) for x, y in zip(np.asarray(xs)[v], np.asarray(ys)[v])}
        assert len(cells) >= 8


class TestOrientationDescriptor:
    def test_ic_angle_gradient(self):
        # horizontal gradient -> centroid to the right -> angle ~ 0
        img = jnp.asarray(np.tile(np.arange(64, dtype=np.float32) * 4, (64, 1)))
        ang = F.ic_angles(img, jnp.array([32]), jnp.array([32]))
        assert abs(float(ang[0])) < 0.1
        # vertical gradient -> angle ~ pi/2
        ang2 = F.ic_angles(img.T, jnp.array([32]), jnp.array([32]))
        assert abs(float(ang2[0]) - np.pi / 2) < 0.1

    def test_brief_rotation_invariance(self):
        # rotate image 90 deg; descriptor at the rotated location should be
        # much closer than random descriptors
        img = synth_texture(128, 128, seed=5)
        imgr = np.rot90(img, k=-1).copy()  # (y, x) -> (x, H-1-y)
        pts = [(40, 50), (70, 64), (90, 38)]
        xs = jnp.array([p[1] for p in pts])
        ys = jnp.array([p[0] for p in pts])
        blur = F.gaussian_blur7(jnp.asarray(img))
        ang = F.ic_angles(jnp.asarray(img), xs, ys)
        d0 = F.brief_descriptors(blur, xs, ys, ang)

        H = img.shape[0]
        xr = jnp.array([H - 1 - p[0] for p in pts])
        yr = jnp.array([p[1] for p in pts])
        blur_r = F.gaussian_blur7(jnp.asarray(imgr))
        ang_r = F.ic_angles(jnp.asarray(imgr), xr, yr)
        d1 = F.brief_descriptors(blur_r, xr, yr, ang_r)

        dist = np.diag(np.asarray(M.hamming_matrix(d0, d1)))
        assert (dist < 70).all(), dist  # random pairs average ~128


class TestExtract:
    def test_extract_end_to_end(self):
        params = OrbParams(n_features=500)
        img = jnp.asarray(synth_texture(240, 320, seed=7))
        feats = F.extract_orb(img, params, 240, 320)
        assert feats.capacity == 512
        v = np.asarray(feats.valid)
        assert v.sum() > 200
        xy = np.asarray(feats.xy)[v]
        assert (xy[:, 0] >= 0).all() and (xy[:, 0] < 320).all()
        assert (xy[:, 1] >= 0).all() and (xy[:, 1] < 240).all()
        # multiple octaves populated
        assert len(set(np.asarray(feats.octave)[v].tolist())) >= 3

    def test_budgets_sum(self):
        budgets = F.features_per_level(1000, 8, 1.2)
        assert sum(budgets) == 1000
        assert budgets[0] > budgets[-1] > 0


class TestMatching:
    def test_hamming_identity(self):
        rng = np.random.default_rng(0)
        d = jnp.asarray(rng.integers(0, 2**32, (16, 8), dtype=np.uint32))
        dist = np.asarray(M.hamming_matrix(d, d))
        assert (np.diag(dist) == 0).all()
        assert dist.mean() > 100  # random off-diagonals ~128

    def test_best_match_ratio(self):
        da = jnp.asarray(np.array([[0, 0, 0, 0, 0, 0, 0, 0]], np.uint32))
        db = jnp.asarray(np.array([
            [0, 0, 0, 0, 0, 0, 0, 1],      # dist 1
            [0xFFFFFFFF] * 8,               # dist 256
        ], np.uint32))
        dist = M.hamming_matrix(da, db)
        res = M.masked_best_match(dist, jnp.ones_like(dist, bool), 50, 0.8)
        assert int(res.idx[0]) == 0 and int(res.dist[0]) == 1
        # ratio test kills ambiguous match
        db2 = jnp.asarray(np.array([[0, 0, 0, 0, 0, 0, 0, 1],
                                    [0, 0, 0, 0, 0, 0, 0, 2]], np.uint32))
        res2 = M.masked_best_match(M.hamming_matrix(da, db2),
                                   jnp.ones((1, 2), bool), 50, 0.8)
        assert int(res2.idx[0]) == -1

    def test_search_for_initialization_translation(self):
        # same descriptors, translated positions within window
        rng = np.random.default_rng(1)
        n = 64
        desc = jnp.asarray(rng.integers(0, 2**32, (n, 8), dtype=np.uint32))
        xy_a = jnp.asarray(rng.uniform(100, 300, (n, 2)).astype(np.float32))
        xy_b = xy_a + 20.0
        valid = jnp.ones((n,), bool)
        ang = jnp.zeros((n,))
        res = M.search_for_initialization(xy_a, desc, valid, ang, xy_b, desc, valid, ang)
        idx = np.asarray(res.idx)
        assert (idx == np.arange(n)).mean() > 0.95

    def test_duplicate_resolution(self):
        res = M.MatchResult(idx=jnp.array([2, 2, 1]), dist=jnp.array([5, 3, 7]))
        out = M.resolve_duplicate_targets(res, 4)
        assert int(out.idx[0]) == -1 and int(out.idx[1]) == 2 and int(out.idx[2]) == 1

    def test_rotation_consistency_rejects_outliers(self):
        n = 100
        ang_a = jnp.zeros((n,))
        ang_b = jnp.concatenate([jnp.full((90,), 0.1), jnp.linspace(1.0, 3.0, 10)])
        idx = jnp.arange(n)
        valid = jnp.ones((n,), bool)
        keep = np.asarray(M.rotation_consistency(ang_a, ang_b, idx, valid))
        assert keep[:90].all()
        assert keep[90:].sum() <= 3


class TestHammingMatrix:
    """ops.matching.hamming_matrix (the XLA expression every matcher uses)
    against the numpy popcount oracle of chip_smoke.py, at the real widths
    and at shapes that are not multiples of 256."""

    @pytest.mark.parametrize("shape", [(1024, 1024), (2048, 2048),
                                       (300, 130), (257, 513), (1, 7)],
                             ids=lambda s: f"{s[0]}x{s[1]}")
    def test_matches_numpy_popcount(self, shape):
        from chip_smoke import hamming_reference
        A, B = shape
        rng = np.random.default_rng(A * 7 + B)
        a = rng.integers(0, 2 ** 32, (A, 8), dtype=np.uint32)
        b = rng.integers(0, 2 ** 32, (B, 8), dtype=np.uint32)
        out = np.asarray(M.hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
        assert out.shape == (A, B) and out.dtype == np.int32
        np.testing.assert_array_equal(out, hamming_reference(a, b))
