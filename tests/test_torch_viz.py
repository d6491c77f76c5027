"""The port's host figure helpers against the JAX package's, on the CPU.

``viz/latent.py``, ``viz/figures.py:nearest_neighbours`` and
``sample_examples_grid``, ``viz/embedding.py:embed_2d``, the video and
image helpers of ``viz/videos.py`` and the synthesis-weight fetcher of
``data/base.py`` hold the JAX functions exactly on the same numpy-seeded
inputs (uint8 arrays bit for bit).  ``create_video_3d``, ``plot_embedding``
and ``make_hist`` draw with cv2 where the JAX package draws with
matplotlib: they are checked for shape, dtype and a drawing, with
matplotlib made unimportable, as on the card's machine.
"""
import os
import sys

import numpy as np
import pytest

from behavior_driven_video_synthesis_tpu.viz import embedding as jax_embedding
from behavior_driven_video_synthesis_tpu.viz import figures as jax_figures
from behavior_driven_video_synthesis_tpu.viz import latent as jax_latent
from behavior_driven_video_synthesis_tpu.viz import videos as jax_videos

from behavior_driven_video_synthesis_tpu_torch.viz import embedding, figures
from behavior_driven_video_synthesis_tpu_torch.viz import latent, videos
from torch_port_threads import one_torch_thread  # noqa: F401

cv2 = pytest.importorskip("cv2")


@pytest.fixture
def no_matplotlib(monkeypatch):
    """matplotlib made unimportable, as on the card's machine."""
    for name in [m for m in sys.modules if m.split(".")[0] == "matplotlib"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)


def _video(seed, t=12, h=10, w=14):
    return (np.random.RandomState(seed).rand(t, h, w, 3) * 255).astype(
        np.uint8)


@pytest.mark.parametrize("parallel", [False, True])
def test_slerp_and_interpolation_paths(parallel):
    rng = np.random.RandomState(0)
    a = rng.randn(16).astype(np.float32)
    b = 2.5 * a if parallel else rng.randn(16).astype(np.float32)
    for v in (0.0, 0.3, 1.0):
        mine, ref = latent.slerp(v, a, b), jax_latent.slerp(v, a, b)
        assert mine.dtype == ref.dtype
        np.testing.assert_array_equal(mine, ref)
    np.testing.assert_array_equal(latent.latent_interpolate(a, b, 7),
                                  jax_latent.latent_interpolate(a, b, 7))


@pytest.mark.parametrize("metric", ["l2", "cos"])
def test_nearest_neighbours(metric):
    rng = np.random.RandomState(1)
    q, db = rng.randn(5, 8), rng.randn(40, 8)
    idx, dist = figures.nearest_neighbours(q, db, k=4, metric=metric)
    ridx, rdist = jax_figures.nearest_neighbours(q, db, k=4, metric=metric)
    np.testing.assert_array_equal(idx, ridx)
    np.testing.assert_allclose(dist, rdist, atol=1e-5, rtol=0)


def test_embed_2d_is_pca_up_to_sign():
    x = np.random.RandomState(2).randn(30, 12) * np.arange(1, 13)
    mine, ref = embedding.embed_2d(x), jax_embedding.embed_2d(x)
    sign = np.sign(np.sum(mine * ref, axis=0))
    np.testing.assert_allclose(mine * sign, ref, atol=1e-6, rtol=0)
    for mod in (embedding, jax_embedding):
        with pytest.raises(ImportError):
            mod.embed_2d(x, method="umap")


@pytest.mark.parametrize("helper", ["filmstrip", "eval_grid",
                                    "enrollment_strip", "samples_grid",
                                    "img_grid"])
def test_grid_helpers_bit_for_bit(helper):
    vids = [_video(s) for s in range(3)]
    calls = {
        "filmstrip": lambda m: m.filmstrip(vids[0], disc_step=5),
        "eval_grid": lambda m: m.make_eval_grid([vids[0], vids[1][:9],
                                                 vids[2]]),
        "enrollment_strip": lambda m: m.make_enrollment_strip(vids[1], 5),
        "samples_grid": lambda m: m.sample_examples_grid(np.stack(vids), 4),
        "img_grid": lambda m: m.make_img_grid(vids[2], n_cols=5),
    }
    mine = calls[helper](figures if helper == "samples_grid" else videos)
    ref = calls[helper](jax_figures if helper == "samples_grid"
                        else jax_videos)
    assert mine.dtype == ref.dtype == np.uint8
    np.testing.assert_array_equal(mine, ref)


def test_text_and_joints_drawn_bit_for_bit():
    rng = np.random.RandomState(3)
    kps = rng.uniform(0, 40, (17, 2))
    joints = jax_videos._H36M_17_LINES
    for colors in (((0, 255, 0),), tuple(tuple(int(c) for c in rng.randint(
            0, 255, 3)) for _ in joints)):
        mine = videos.add_joints_to_img(_video(4, 1, 48, 48)[0], kps, joints,
                                        color_joints=colors)
        ref = jax_videos.add_joints_to_img(_video(4, 1, 48, 48)[0], kps,
                                           joints, color_joints=colors)
        np.testing.assert_array_equal(mine, ref)
    mine = videos.text_to_vid(_video(5, 3, 40, 60), "a7", (5, 20))
    ref = jax_videos.text_to_vid(_video(5, 3, 40, 60), "a7", (5, 20))
    np.testing.assert_array_equal(mine, ref)
    assert not np.array_equal(mine, _video(5, 3, 40, 60))


def test_synth_weights_fetcher_matches_jax(tmp_path):
    """The synthesis-weight maps of a DeepFashion tree: 10 inside each
    frame's keypoint hull, 1 elsewhere, as the JAX dataset gives them."""
    from behavior_driven_video_synthesis_tpu.data.deepfashion import (
        DeepFashionDataset as JaxDeepFashion)
    from test_file_datasets import make_index_fixture

    from behavior_driven_video_synthesis_tpu_torch.data.deepfashion import (
        DeepFashionDataset)

    root = make_index_fixture(str(tmp_path / "df"), n=6, size=32)
    kw = dict(datapath=root, spatial_size=32)
    mine = DeepFashionDataset(None, ["synth_weights"], (0, 0), "train", **kw)
    ref = JaxDeepFashion(None, ["synth_weights"], (0, 0), mode="train", **kw)
    for i in range(len(ref)):
        a, b = mine[i]["synth_weights"], ref[i]["synth_weights"]
        assert a.dtype == b.dtype == np.float32 and a.shape == (32, 32, 1)
        np.testing.assert_array_equal(a, b)
        assert set(np.unique(a)) == {1.0, 10.0}


def test_skeleton_video_drawn_without_matplotlib(tmp_path, no_matplotlib):
    poses = np.random.RandomState(6).randn(5, 17, 3)
    frames = videos.create_video_3d(poses, out_path=str(tmp_path / "v.mp4"))
    assert frames.shape == (5, 400, 400, 3) and frames.dtype == np.uint8
    assert np.all(frames[:, 0, 0] == 255)             # white background
    assert all((f < 255).any() for f in frames)      # a skeleton each
    cap = cv2.VideoCapture(str(tmp_path / "v.mp4"))
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 5
    cap.release()
    # the JAX default's frame size (4 x 4 inches at 100 dpi), and lines
    # that index joints the pose lacks are skipped, as there
    assert videos.create_video_3d(poses[:2, :3], lines=[(0, 1), (1, 5)],
                                  figsize=(3, 2)).shape == (2, 200, 300, 3)


def test_embedding_and_histogram_without_matplotlib(tmp_path,
                                                    no_matplotlib):
    rng = np.random.RandomState(7)
    img = embedding.plot_embedding(rng.randn(40, 8), rng.randint(0, 5, 40),
                                   str(tmp_path / "emb.png"))
    assert img.shape == (600, 600, 3) and img.dtype == np.uint8
    assert len(np.unique(img.reshape(-1, 3), axis=0)) > 5
    hist = embedding.make_hist(rng.rand(50), str(tmp_path / "hist.png"))
    assert hist.shape == (360, 600, 3) and hist.dtype == np.uint8
    assert (hist == embedding.TAB10[0]).all(-1).any()   # the bars
    for name, want in (("emb.png", img), ("hist.png", hist)):
        back = cv2.cvtColor(cv2.imread(str(tmp_path / name)),
                            cv2.COLOR_BGR2RGB)
        np.testing.assert_array_equal(back, want)
    assert embedding.plot_embedding(rng.randn(10, 3)).shape == (600, 600, 3)


def test_nearest_neighbour_figure(tmp_path, no_matplotlib):
    rng = np.random.RandomState(8)
    betas, seqs = rng.randn(6, 4), rng.randn(6, 7, 51)
    path = figures.nearest_neighbour_figure(
        betas, seqs, rng.randint(0, 3, (6, 1)), str(tmp_path / "nn.png"),
        n_queries=2, k=2, n_frames=3)
    assert os.path.basename(path) == "nn.png"
    img = cv2.imread(path)
    # 2 query rows; a row is the query's strip and its 2 neighbours'
    assert img.shape == (2 * 400, 3 * (3 * 402 - 2), 3)
