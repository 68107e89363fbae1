"""The fused patchify's plain version (``ops/patchify.py``) against the JAX
Pallas kernel in interpret mode on clouds that make exact ties (integer
lattices, duplicated and zeroed points), which pins the lowest-index-first
rule of both the FPS argmax and the kNN extraction; and the FPS launch plan
(``ops/fps.py:plan``), which the fps kernel and the patchify's FPS phase
share, for every size of cloud."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point_dae_tpu.ops.pallas_patchify import fused_patchify_pallas

from point_dae_torch.ops import fps, patchify

from _torch_files import one_torch_thread  # noqa: F401


def _cloud(kind, B, N, seed):
    rng = np.random.default_rng(seed)
    if kind == "lattice":          # 729 positions for N points: equal distances everywhere
        pts = rng.integers(-4, 5, size=(B, N, 3)).astype(np.float32)
    elif kind == "half_lattice":   # a finer lattice, still exact in f32
        pts = rng.integers(-6, 7, size=(B, N, 3)).astype(np.float32) * 0.5
    else:                          # normal points, the second half a copy of the first
        pts = rng.normal(size=(B, N, 3)).astype(np.float32)
        pts[:, N // 2:] = pts[:, :N // 2]
    pts[:, 7:15] = 0.0             # zeroed points: never picked after the first
    pts[0, 40] = np.float32(0.018)  # |p|^2 = 9.7e-4, inside the unselectable radius
    return pts


@pytest.mark.parametrize("kind,G", [("lattice", 16), ("half_lattice", 12), ("duplicated", 8)])
def test_plain_patchify_matches_pallas_at_exact_ties(kind, G):
    B, N, S = 2, 512, 8
    pts = _cloud(kind, B, N, G)
    fps_j, knn_j = fused_patchify_pallas(jnp.asarray(pts), G, S, batch_tile=1,
                                         interpret=True)
    fps_t, knn_t = patchify.fused_patchify_plain(torch.from_numpy(pts), G, S)
    np.testing.assert_array_equal(fps_t.numpy(), np.asarray(fps_j))
    np.testing.assert_array_equal(knn_t.numpy(), np.asarray(knn_j))
    assert not np.isin(fps_t[:, 1:].numpy(), np.arange(7, 15)).any()
    # the ties are real: some kNN row holds equal distances, lowest index first
    centre = pts[np.arange(B)[:, None], fps_t.numpy()]                  # (B, G, 3)
    d = ((pts[:, None] - centre[:, :, None]) ** 2).sum(-1)              # (B, G, N)
    picked = np.take_along_axis(d, knn_t.numpy().astype(np.int64), -1)
    tied = picked[..., 1:] == picked[..., :-1]
    assert tied.any()
    assert (knn_t.numpy()[..., 1:][tied] > knn_t.numpy()[..., :-1][tied]).all()


B_CLASSES = (1, 8, 16, 32, 256)
# every class of cloud size: below a warp, one block's forms, a cluster's,
# the most the registers hold and the streamed form past it
N_CLASSES = (1, 31, 32, 100, 511, 512, 1000, 1024, 1200, 2047, 2048, 4096, 8191, 8192, 8193,
             16384, 20000, 32768, 65535, 65536, 65537, 100000, 1 << 20)


@pytest.mark.parametrize("N", N_CLASSES)
def test_plan_gives_a_form_for_every_cloud_size(N):
    for B in B_CLASSES:
        p = fps.plan(B, N)
        assert p.form in ("block", "cluster", "stream")
        if N > fps.REGISTER_POINTS:
            assert p == fps.FpsPlan(1, fps.STREAM_THREADS, 0)
            continue
        assert p.ppt in fps.PPTS and p.cluster in fps.CLUSTERS
        assert 32 <= p.threads <= fps.BLOCK_THREADS and p.threads % 32 == 0
        assert p.cluster * p.threads * p.ppt >= N                  # the registers hold it
        assert p.cluster == 1 or (p.cluster - 1) * p.threads < N   # every block holds points
        forced = 1 << max(-(-N // fps.BLOCK_POINTS) - 1, 0).bit_length()   # blocks the registers need
        assert p.cluster >= forced
        if p.cluster > max(forced, 1):                             # spread by choice
            assert B * p.cluster <= 132 and N >= p.cluster * fps.MIN_SHARE
            assert p.cluster <= fps.MAX_SPREAD


def test_plan_at_the_paths_shapes():
    """The DGCNN fine-tune's 8192 points spread over clusters of four blocks
    of 2048; 2048 points or fewer keep one block of at most four warps; the
    flagship's 256 clouds keep one block each; a cloud past the registers
    streams."""
    assert fps.plan(32, 8192) == fps.FpsPlan(4, 128, 16)
    assert fps.plan(32, 16384) == fps.FpsPlan(4, 128, 32)
    assert fps.plan(32, 2048) == fps.FpsPlan(1, 128, 16)
    assert fps.plan(32, 1200) == fps.FpsPlan(1, 96, 16)
    assert fps.plan(256, 1024) == fps.plan(128, 1024) == fps.FpsPlan(1, 128, 8)
    assert fps.plan(32, 65537).form == "stream"
    assert fps.plan(1, 65536).cluster == 8


def test_plan_keeps_every_cluster_on_the_card_at_once():
    """A cluster size the card cannot hold for every cloud at once is not
    chosen (unless the registers need it)."""
    def slots(table):
        return lambda c, threads, ppt: table[c]

    assert fps.plan(32, 8192, 132, slots({2: 66, 4: 33, 8: 16})).cluster == 4
    assert fps.plan(32, 8192, 132, slots({2: 66, 4: 28, 8: 14})).cluster == 2
    assert fps.plan(32, 65536, 132, slots({2: 66, 4: 28, 8: 14})).cluster == 8


@pytest.mark.parametrize("N,S,takes", [(512, 32, True), (2048, 32, True), (4096, 16, True),
                                       (patchify.MAX_POINTS, 32, True),
                                       (patchify.MAX_POINTS + 1, 32, False), (16, 32, False),
                                       (1024, 0, False)])
def test_patchify_kernel_takes(N, S, takes):
    assert patchify.kernel_takes(N, S) is takes
