"""The launch geometry of the GAE and discounted-return CUDA kernels, and the
kernels' walk over it, on the CPU.

``csrc/gae.cu`` cannot run here, so what surrounds its arithmetic is pinned
in Python: ``_launch_geometry`` (which the wrappers pass to the C entries)
must cover every (t, column) once, fit the card's shared memory and fill the
card at the main path's shape; and a walk in the kernel's order (column
tiles, chunks from the last backwards through the ring of stages, the carry
and V_{t+1} kept across chunk edges) must give what the Pallas kernels give
in interpret mode.

The Pallas kernels tile b (padded to 128) by 512 columns and launch
``b_pad // 512`` tiles, so where b_pad > 512 is no multiple of 512 they leave
the last columns unwritten (b=1280, the SMACLite FP layout: columns
1024-1279; NaN in interpret mode). There the walk is held against the Pallas
kernel on the columns it writes and against the JAX ``lax.scan`` form on all.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from harl_tpu.ops import returns as jret
from harl_tpu.ops.pallas_gae import discounted_returns_pallas, gae_pallas
from harl_tpu_torch.ops import _build
from harl_tpu_torch.ops import gae_kernels as K

# float32 recursions; the walk and the Pallas kernel round in another order
RTOL = ATOL = 1e-5
GAMMA, LAM = 0.99, 0.95


def _chunks(T, Tc):
    """(k, t0, rows) of every chunk, in the order the kernel walks them."""
    n = -(-T // Tc)
    return [(k, k * Tc, min(Tc, T - k * Tc)) for k in range(n - 1, -1, -1)]


def _ring(T, Tc, stages):
    """The stage each chunk is read from, in the kernel's order, replaying
    its copies: the first ``stages`` chunks before the first wait, then each
    stage refilled with the chunk ``stages`` further down once it is read."""
    chunks = _chunks(T, Tc)
    held = [chunks[s][0] if s < len(chunks) else None for s in range(stages)]
    in_flight_at_first_wait = sum(h is not None for h in held)
    order = []
    for i, (k, _, _) in enumerate(chunks):
        slot = i % stages
        assert held[slot] == k, (i, held)
        order.append(slot)
        held[slot] = k - stages if k - stages >= 0 else None
    return order, in_flight_at_first_wait


@pytest.mark.parametrize("b", [1, 7, 1280, 4096, 5000])
@pytest.mark.parametrize("T", [1, 9, 32, 70, 200, 1024])
def test_geometry_covers_every_element_once_and_fits(T, b):
    W, Tc, stages, smem, grid = K._launch_geometry(T, b)
    assert W in (8, 16, 32) and 1 <= Tc <= T
    assert (grid - 1) * W < b <= grid * W
    cover = np.zeros((T, b), np.int8)
    for tile in range(grid):
        cols = slice(tile * W, min(b, (tile + 1) * W))
        for _, t0, rows in _chunks(T, Tc):
            cover[t0:t0 + rows, cols] += 1
    assert (cover == 1).all()
    order, in_flight = _ring(T, Tc, stages)
    assert stages >= 2 and in_flight == min(stages, len(order))
    assert smem == min(stages, len(order)) * 4 * Tc * W * 4
    assert smem <= K.MAX_SMEM
    if smem > K.DEFAULT_SMEM:
        source = (_build.CSRC / "gae.cu").read_text()
        assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in source


def test_main_shape_fills_the_card_with_every_load_in_flight():
    W, Tc, stages, _, grid = K._launch_geometry(32, 4096)
    assert grid >= 128
    _, in_flight = _ring(32, Tc, stages)
    assert in_flight == len(_chunks(32, Tc))
    # and a long T runs through the ring with several chunks in flight
    _, in_flight = _ring(1024, K._launch_geometry(1024, 4096)[1], stages)
    assert in_flight == stages


def _walk(kind, r, v, m, bad, nv):
    """The kernels' order in Python: per column tile, per chunk from the
    last, per row downwards, reading each chunk's rows as a stage holds them
    (rewards and values rows t, masks and bad masks rows t+1)."""
    T, b = r.shape
    W, Tc, stages, _, grid = K._launch_geometry(T, b)
    f = np.float32
    ones = np.ones_like(m)
    bad = ones if bad is None else bad
    out = np.full((T, b), np.nan, f)
    for tile in range(grid):
        cols = slice(tile * W, min(b, (tile + 1) * W))
        carry = np.zeros(cols.stop - cols.start, f) if kind == "gae" else nv[cols].copy()
        v_next = v[T, cols]
        for _, t0, rows in _chunks(T, Tc):
            stage = (r[t0:t0 + rows, cols], v[t0:t0 + rows, cols],
                     m[t0 + 1:t0 + rows + 1, cols], bad[t0 + 1:t0 + rows + 1, cols])
            for i in range(rows - 1, -1, -1):
                rw, vv, mm, bm = (x[i] for x in stage)
                if kind == "gae":
                    delta = rw + f(GAMMA) * v_next * mm - vv
                    carry = (delta + f(GAMMA * LAM) * mm * carry) * bm
                    out[t0 + i, cols] = carry + vv
                    v_next = vv
                else:
                    carry = (carry * f(GAMMA) * mm + rw) * bm + (f(1) - bm) * vv
                    out[t0 + i, cols] = carry
    return out


@pytest.mark.parametrize("with_bad", [True, False])
@pytest.mark.parametrize("T,trailing", [(1, (7, 1)), (33, (1, 1)), (70, (256, 5, 1)),
                                        (200, (20, 1)), (64, (4096, 1))])
@pytest.mark.parametrize("kind", ["gae", "returns"])
def test_walk_in_kernel_order_matches_pallas(kind, T, trailing, with_bad):
    rng = np.random.default_rng(T + len(trailing))
    f = np.float32
    r = rng.normal(size=(T,) + trailing).astype(f)
    v = rng.normal(size=(T + 1,) + trailing).astype(f)
    m = (rng.uniform(size=(T + 1,) + trailing) > 0.15).astype(f)
    bad = (rng.uniform(size=(T + 1,) + trailing) > 0.1).astype(f) if with_bad else None
    flat = lambda x: None if x is None else x.reshape(x.shape[0], -1)
    jr, jv, jm = jnp.asarray(r), jnp.asarray(v), jnp.asarray(m)
    jb = None if bad is None else jnp.asarray(bad)
    if kind == "gae":
        pallas = gae_pallas(jr, jv, jm, jb, GAMMA, LAM, interpret=True)
        scan = jret.compute_gae(jr, jv, jm, jb, GAMMA, LAM)
    else:
        pallas = discounted_returns_pallas(jr, jv, jm, jb, jv[-1], GAMMA, interpret=True)
        scan = jret.compute_discounted_returns(jr, jv, jm, jb, jv[-1], GAMMA)
    out = _walk(kind, flat(r), flat(v), flat(m), flat(bad), v[-1].reshape(-1))
    b = out.shape[1]
    b_pad = max(128, -(-b // 128) * 128)
    written = min(b, b_pad // min(512, b_pad) * min(512, b_pad))
    np.testing.assert_allclose(out[:, :written], np.asarray(pallas).reshape(T, -1)[:, :written],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out, np.asarray(scan).reshape(T, -1), rtol=RTOL, atol=ATOL)
