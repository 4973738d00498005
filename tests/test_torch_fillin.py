"""The port's fill-in (`ops.image.fillin_masked`; on the CPU its plain
version, `fillin_plain`) against the JAX package's `fillin_masked`, a
`lax.while_loop`: x and m bit for bit (NaNs where JAX has them, every
other value with its bits, -0.0 included), and the rounds that filled
something counted by stepping the JAX body by hand. The kernel itself
runs only on a card (tests/test_torch_cuda.py, chip_smoke.py phase 3b).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from torch_parity import n, t

from mhmocap_tpu.ops import image as JI
from mhmocap_tpu_torch.ops import image as TI


def assert_bits_equal(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    np.testing.assert_array_equal(got, ref)
    nan = np.isnan(ref)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got.view(np.uint32)[~nan],
                                  ref.view(np.uint32)[~nan])


def jax_rounds(x, m, k, max_iters=64):
    """The rounds of JAX's loop that fill a pixel, stepping its body by
    hand under its condition (mask not full, below max_iters) -> (the
    number of such rounds, x, m after the loop)."""
    xv, mv = jnp.asarray(x, jnp.float32), jnp.asarray(m, jnp.float32)
    rounds = 0
    for _ in range(max_iters):
        if not bool(jnp.min(mv) < 0.5):
            break
        med, ok = JI.masked_window_median(xv, mv, k)
        newly = (mv < 0.5) & ok
        rounds += bool(newly.any())
        xv = jnp.where(newly, med, xv)
        mv = jnp.where(newly, 1.0, mv)
    return rounds, np.asarray(xv), np.asarray(mv)


def run_both(x, m, k, max_iters=64):
    ref_x, ref_m = JI.fillin_masked(jnp.asarray(x), jnp.asarray(m), k,
                                    max_iters)
    got_x, got_m, filled = TI.fillin_plain(t(x), t(m), k, max_iters)
    assert_bits_equal(n(got_x), ref_x)
    assert_bits_equal(n(got_m), ref_m)
    rounds, hx, hm = jax_rounds(x, m, k, max_iters)
    assert_bits_equal(hx, ref_x)
    assert_bits_equal(hm, ref_m)
    assert sum(f > 0 for f in filled) == rounds
    assert all(f > 0 for f in filled[:rounds])
    # the wrapper on CPU tensors is the plain version
    wx, wm = TI.fillin_masked(t(x), t(m), k, max_iters)
    assert_bits_equal(n(wx), ref_x)
    assert_bits_equal(n(wm), ref_m)
    return rounds, filled


def _holes(shape, seed):
    rng = np.random.RandomState(seed)
    x = rng.rand(*shape).astype(np.float32)
    m = np.ones(shape, np.float32)
    H, W = shape
    m[H // 4:H // 2, W // 5:W - 3] = 0
    m[H - 4:, :4] = 0
    m[rng.rand(*shape) < 0.1] = 0
    return x, m


@pytest.mark.parametrize("k", [5, 7, 11])
def test_hole_fills_before_the_cap(k):
    x, m = _holes((40, 36), k)
    rounds, filled = run_both(x, m, k)
    assert 0 < rounds < 64
    assert filled[rounds] == 0 and len(filled) == rounds + 1


def test_cap_binds_at_k3():
    """A hole 140 px wide gains a 1-px ring a round at k = 3, so 64
    rounds leave its middle masked in both."""
    x = np.random.RandomState(7).rand(150, 150).astype(np.float32)
    m = np.zeros((150, 150), np.float32)
    m[:5] = m[-5:] = 1
    m[:, :5] = m[:, -5:] = 1
    rounds, filled = run_both(x, m, 3)
    assert rounds == 64 and len(filled) == 64
    got_m = n(TI.fillin_plain(t(x), t(m), 3)[1])
    assert (got_m < 0.5).sum() > 0


@pytest.mark.parametrize("case", ["no_valid", "full", "half", "nan_mask"])
def test_masks_that_fill_nothing(case):
    """No valid pixel (JAX runs 64 rounds that fill nothing), a full
    mask, a mask of 0.5 (neither filled nor used) and a mask holding a
    NaN (JAX's condition is false at once): 0 rounds fill a pixel."""
    rng = np.random.RandomState(3)
    x = rng.rand(20, 24).astype(np.float32)
    m = {"no_valid": np.zeros((20, 24), np.float32),
         "full": np.ones((20, 24), np.float32),
         "half": np.where(rng.rand(20, 24) < 0.5, 0.5, 1.0),
         "nan_mask": np.where(rng.rand(20, 24) < 0.3, 0.0, 1.0)}[case]
    m = m.astype(np.float32)
    if case == "nan_mask":
        m[3, 4] = np.nan
    rounds, filled = run_both(x, m, 7)
    assert rounds == 0 and filled == [0]


def test_half_mask_is_neither_filled_nor_used():
    """Pixels with m == 0.5 beside holes: they stay as they are and are
    no neighbour, while the holes fill from the valid pixels."""
    x, m = _holes((30, 30), 11)
    m[m == 0] = np.where(np.random.RandomState(1).rand(int((m == 0).sum()))
                         < 0.3, 0.5, 0.0).astype(np.float32)
    rounds, _ = run_both(x, m, 5)
    assert rounds > 0


def test_batch_of_frames_against_vmap():
    """Frames that need 0, 1, a few and many rounds, and one with a NaN
    in its mask, as one (B, H, W) batch against jax.vmap of the loop (as
    the JAX ingestion runs it); stopping on the batch gives each frame's
    own result."""
    H, W, k = 32, 28, 7
    rng = np.random.RandomState(5)
    x = rng.randn(6, H, W).astype(np.float32)
    m = np.ones((6, H, W), np.float32)
    m[1, 10, 10] = 0
    m[2, 5:15, 5:20] = 0
    m[3, :, 2:] = 0
    m[4] = 0
    m[5, 3:9, 3:9] = 0
    m[5, 0, 0] = np.nan
    f = jax.vmap(lambda a, b: JI.fillin_masked(a, b, k))
    ref_x, ref_m = f(jnp.asarray(x), jnp.asarray(m))
    got_x, got_m, filled = TI.fillin_plain(t(x), t(m), k)
    assert_bits_equal(n(got_x), ref_x)
    assert_bits_equal(n(got_m), ref_m)
    per_frame = [jax_rounds(x[i], m[i], k)[0] for i in range(6)]
    assert per_frame[0] == per_frame[4] == per_frame[5] == 0
    assert per_frame[1] == 1 and per_frame[3] > per_frame[2] > 1
    assert sum(f > 0 for f in filled) == max(per_frame)
    for i in range(6):
        fx, fm, _ = TI.fillin_plain(t(x[i]), t(m[i]), k)
        assert_bits_equal(n(fx), n(got_x)[i])
        assert_bits_equal(n(fm), n(got_m)[i])


@pytest.mark.parametrize("k", [3, 5, 7])
def test_inf_nan_and_signed_zeros(k):
    """Values from {+-0.0, +-1, +-inf, NaN, 3.4e38} and a few others, so
    that medians land on ties of zeros of both signs (JAX's stable sort
    keeps their window order and bits), on infinities, on the invalid
    slots' 3.4e38 and on NaN (after +inf)."""
    rng = np.random.RandomState(10 + k)
    pool = np.array([0.0, -0.0, 1.0, -1.0, np.inf, -np.inf, np.nan, 3.4e38,
                     0.25, -2.5], np.float32)
    x = pool[rng.randint(0, len(pool), (24, 26))]
    # zeros of both signs on the left; infinities, NaN and 3.4e38 on
    # the right, under a denser mask
    x[:, :13][rng.rand(24, 13) < 0.6] = -0.0
    x[:, 13:] = pool[[4, 4, 5, 6, 6, 6, 7]][rng.randint(0, 7, (24, 13))]
    m = (rng.rand(24, 26) < 0.55).astype(np.float32)
    m[:, 13:] = rng.rand(24, 13) < 0.9
    m[8:16, 8:18] = 0
    # a frame whose one hole sees mostly NaN: its median is NaN
    x_nan = np.full((7, 7), np.nan, np.float32)
    x_nan[0] = 1.0
    m_nan = np.ones((7, 7), np.float32)
    m_nan[3, 3] = 0
    got = []
    for xi, mi in ((x, m), (x_nan, m_nan)):
        rounds, _ = run_both(xi, mi, k)
        assert rounds > 0
        gx, gm, _ = TI.fillin_plain(t(xi), t(mi), k)
        got.append(n(gx)[(mi < 0.5) & (n(gm) > 0.5)])
    assert np.signbit(got[0][got[0] == 0]).any()
    assert np.isinf(got[0]).any() and np.isnan(got[1]).all()


def test_masked_window_median_matches():
    """One round's median and validity, with signed zeros, inf and NaN
    among the values, bit for bit."""
    rng = np.random.RandomState(12)
    pool = np.array([0.0, -0.0, 1.5, np.inf, np.nan, -3.0], np.float32)
    x = pool[rng.randint(0, len(pool), (18, 20))]
    m = (rng.rand(18, 20) < 0.6).astype(np.float32)
    rmed, rok = JI.masked_window_median(jnp.asarray(x), jnp.asarray(m), 5)
    gmed, gok = TI.masked_window_median(t(x), t(m), 5)
    np.testing.assert_array_equal(n(gok), np.asarray(rok))
    assert_bits_equal(n(gmed), rmed)
